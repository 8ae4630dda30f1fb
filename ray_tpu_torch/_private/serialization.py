# Copied from ray_tpu/_private/serialization.py (JAX-free), with a pickler
# of its own that sends torch tensors out of band (`_reduce_tensor`).
"""Object serialization with zero-copy buffer support.

Mirrors the contract of the reference's SerializationContext
(reference: python/ray/_private/serialization.py:122 — cloudpickle with
out-of-band pickle-protocol-5 buffers so large numpy/arrow payloads are
written/read from plasma without copies).

Here the on-wire layout is:

    [8-byte header len][pickled header][buffer 0][buffer 1]...

The header holds the protocol-5 in-band pickle bytes plus per-buffer
(offset, length, alignment) metadata. Writing into a shared-memory
object therefore needs exactly one pass over the buffers, and reading
reconstructs numpy/jax arrays as views over the mapped memory —
zero-copy, which is what lets the store feed `jax.numpy.asarray` /
dlpack without a host copy (SURVEY.md §7 hard part 3).

ObjectRefs embedded inside values are recorded in the header so the
owner can track borrowed references (reference:
core_worker/reference_count.h borrower protocol).

Torch tensors: PyTorch pickles a tensor in band (its storage bytes go
into the pickle stream). This module's pickler sends a CPU tensor as a
numpy view of its storage instead, so the bytes travel as one
out-of-band buffer. A writable buffer comes back as a tensor over it
(no copy); a read-only one, such as a sealed object in the store, as a
copy of it, since sealed objects are immutable and a tensor cannot be
read-only. bf16 (and the float8 types) have no numpy dtype: they travel
as an integer view of the same width and are reinterpreted on the way
back. A CUDA tensor is staged to the host and restored onto "cuda" (the
reader's current card) in the reader; a reader without a card raises.
"""

from __future__ import annotations

import io
import pickle
import struct
import sys
from dataclasses import dataclass, field
from typing import Any

import cloudpickle

_ALIGN = 64  # TPU-friendly alignment for zero-copy into XLA.


@dataclass
class SerializedObject:
    """A value serialized into header bytes + out-of-band buffers."""

    inband: bytes
    buffers: list[memoryview] = field(default_factory=list)

    def total_size(self) -> int:
        size = 8 + len(self._header())
        for buf in self.buffers:
            size = _align_up(size)
            size += buf.nbytes
        return size

    def _header(self) -> bytes:
        return pickle.dumps(
            {
                "inband": self.inband,
                "nbytes": [buf.nbytes for buf in self.buffers],
            },
            protocol=5,
        )

    def write_to(self, target: memoryview) -> int:
        """Write the full wire format into `target`; returns bytes used."""
        header = self._header()
        struct.pack_into(">Q", target, 0, len(header))
        target[8 : 8 + len(header)] = header
        cursor = 8 + len(header)
        for buf in self.buffers:
            cursor = _align_up(cursor)
            flat = buf.cast("B") if buf.ndim != 1 or buf.format != "B" else buf
            target[cursor : cursor + flat.nbytes] = flat
            cursor += flat.nbytes
        return cursor

    def to_bytes(self) -> bytes:
        out = bytearray(self.total_size())
        used = self.write_to(memoryview(out))
        return bytes(out[:used])


def _align_up(n: int) -> int:
    return (n + _ALIGN - 1) // _ALIGN * _ALIGN


def _tensor_types():
    """(torch.Tensor, torch.nn.Parameter), or () while torch is not
    imported: a process that never imported torch holds no tensor."""
    torch = sys.modules.get("torch")
    if torch is None or not hasattr(torch, "nn"):
        return ()
    return (torch.Tensor, torch.nn.Parameter)


def _reduce_tensor(tensor):
    """(rebuild, args) of a dense CPU or CUDA tensor: its bytes as one
    contiguous numpy array, which protocol 5 sends out of band."""
    import torch

    device = tensor.device.type
    if tensor.layout != torch.strided or device not in ("cpu", "cuda"):
        return NotImplemented
    data = tensor.detach()
    if device == "cuda":
        data = data.cpu()
    data = data.contiguous()
    dtype = data.dtype
    try:
        array = data.numpy()
    except TypeError:
        # No numpy dtype (bf16, float8): an integer view of its width.
        width = _INT_OF_WIDTH[data.element_size()]
        array = data.view(getattr(torch, width)).numpy()
    return _rebuild_tensor, (
        array, str(dtype).removeprefix("torch."), device,
        tensor.requires_grad, isinstance(tensor, torch.nn.Parameter),
    )


#: Element width in bytes -> the torch integer dtype that views it.
_INT_OF_WIDTH = {1: "uint8", 2: "int16", 4: "int32", 8: "int64"}


def _rebuild_tensor(array, dtype, device, requires_grad, parameter):
    import torch

    if not array.flags.writeable:
        # A read-only buffer is a sealed object's (or bytes): numpy
        # hands back a read-only view of it, but a tensor cannot be
        # read-only, so the reader gets its own copy, and an in-place
        # op cannot rewrite the object under its other readers.
        array = array.copy()
    tensor = torch.from_numpy(array)
    dtype = getattr(torch, dtype)
    if tensor.dtype != dtype:
        tensor = tensor.view(dtype)
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "a CUDA tensor cannot be restored in a process without a "
                "card: run the reader with num_gpus > 0")
        tensor = tensor.to("cuda")
    if parameter:
        return torch.nn.Parameter(tensor, requires_grad=requires_grad)
    return tensor.requires_grad_(requires_grad)


class _Pickler(cloudpickle.Pickler):
    """cloudpickle's pickler, with torch tensors reduced by
    `_reduce_tensor` (per pickler: no global copyreg entry, so
    `torch.save` and torch's own multiprocessing are untouched)."""

    def reducer_override(self, obj):
        types = _tensor_types()
        if types and type(obj) in types:
            reduced = _reduce_tensor(obj)
            if reduced is not NotImplemented:
                return reduced
        return super().reducer_override(obj)


class SerializationContext:
    """Pickles values with out-of-band protocol-5 buffers.

    ObjectRefs embedded in values survive the trip via
    ObjectRef.__reduce__, which re-attaches them to the receiving
    process's worker and notifies the owner of the borrow."""

    def __init__(self, ref_class: type | None = None):
        self._ref_class = ref_class

    def serialize(self, value: Any) -> SerializedObject:
        buffers: list[pickle.PickleBuffer] = []
        # cloudpickle so lambdas/closures/local functions work as task
        # args and return values (reference vendors cloudpickle for the
        # same reason, python/ray/cloudpickle/).
        with io.BytesIO() as file:
            _Pickler(
                file, protocol=5, buffer_callback=buffers.append
            ).dump(value)
            inband = file.getvalue()
        return SerializedObject(
            inband=inband, buffers=[b.raw() for b in buffers]
        )

    def deserialize(
        self, data: memoryview | bytes, buffer_wrap=None
    ) -> Any:
        """Reconstruct a value; out-of-band buffers are zero-copy views
        into `data`. `buffer_wrap(mv) -> buffer` lets the caller wrap
        each out-of-band slice in a lifetime-tracking object (the
        native arena ties reader pins to buffer lifetime this way)."""
        view = memoryview(data)
        (header_len,) = struct.unpack_from(">Q", view, 0)
        header = pickle.loads(bytes(view[8 : 8 + header_len]))
        cursor = 8 + header_len
        buffers = []
        for nbytes in header["nbytes"]:
            cursor = _align_up(cursor)
            chunk = view[cursor : cursor + nbytes]
            buffers.append(
                chunk if buffer_wrap is None else buffer_wrap(chunk)
            )
            cursor += nbytes
        return pickle.loads(header["inband"], buffers=buffers)
