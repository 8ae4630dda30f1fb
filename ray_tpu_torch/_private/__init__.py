"""Runtime internals of the PyTorch/CUDA port: a copy of
`ray_tpu/_private/` (the JAX package's runtime imports no JAX), each
module with a header naming its source and what the port changed.
`protocol.proto` and `protocol_pb2.py` are byte-identical copies of
`ray_tpu/_private/`'s: both register the same `ray_tpu.wire.Frame` in
protobuf's default pool, which takes an identical registration twice,
so the two must never differ. What each copy changes is the reviewed
patch `ray_tpu_torch/fork.patch`; `tests/test_torch_fork.py` holds every
copy to its source plus that patch."""
