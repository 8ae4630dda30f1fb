# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: protocol.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0eprotocol.proto\x12\x0cray_tpu.wire\"[\n\x05\x46rame\x12\x0f\n\x07version\x18\x01 \x01(\r\x12\x0e\n\x06method\x18\x02 \x01(\t\x12\x0b\n\x03mid\x18\x03 \x01(\x12\x12\x0f\n\x07\x63hannel\x18\x04 \x01(\t\x12\x13\n\x0b\x62uffer_lens\x18\x05 \x03(\x04\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'protocol_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _FRAME._serialized_start=32
  _FRAME._serialized_end=123
# @@protoc_insertion_point(module_scope)
