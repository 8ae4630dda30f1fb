# Copied from ray_tpu/_private/wire.py (JAX-free): module names read ray_tpu_torch.
"""Typed wire schema + protocol versioning for the RPC plane.

Reference behavior matched: src/ray/protobuf/*.proto — every RPC has a
typed message schema, and incompatible peers fail cleanly. Here:

* The frame ENVELOPE (method, correlation id, push channel, version)
  is protobuf (`protocol.proto` / `protocol_pb2.py`).
* The protocol version is negotiated at connection handshake (the
  server's nonce frame carries it) and stamped on every frame.
* Per-method argument schemas (`SCHEMAS`) are validated server-side
  before dispatch: unknown methods and mistyped/missing fields produce
  a clean typed error instead of a KeyError deep inside a handler.
  tests/test_wire_schema.py asserts the registry covers every method
  the daemon registers.

The argument payload itself stays a pickled dict behind the HMAC
(authenticated before any bytes reach the deserializer) — a documented
trade for Python-only workers and pickle5 zero-copy buffers.
"""

from __future__ import annotations

import pickle
from typing import Any, Dict, Optional, Tuple

from .protocol_pb2 import Frame

PROTOCOL_VERSION = 1


class ProtocolVersionError(Exception):
    """Peer speaks a different wire protocol version."""


class SchemaError(Exception):
    """Message failed per-method schema validation."""


# -- frame codec -------------------------------------------------------


import struct as _struct

_ENV_LEN = _struct.Struct(">I")


def encode_frame_buffers(msg: Dict[str, Any]) -> list:
    """Internal message dict -> list of wire buffers:
    [env-len + envelope + pickled body, oob buffer, oob buffer, ...]

    pickle protocol 5 hands large binary values (PickleBuffer-backed
    objects: numpy arrays, PickleBuffer wrappers) to the
    buffer_callback instead of copying them into the stream; their
    lengths ride in the envelope (Frame.buffer_lens) and the raw
    buffers are scatter-gathered onto the socket AS-IS — the
    object-transfer fast path (reference: PushManager chunk bytes,
    minus the protobuf-copy tax)."""
    body = {
        k: v
        for k, v in msg.items()
        if k not in ("_method", "_mid", "_push")
    }
    oob: list = []
    body_bytes = (
        pickle.dumps(body, protocol=5, buffer_callback=oob.append)
        if body
        else b""
    )
    raw = [buf.raw() for buf in oob]
    frame = Frame(
        version=PROTOCOL_VERSION,
        method=msg.get("_method", ""),
        mid=msg.get("_mid") or 0,
        channel=msg.get("_push", ""),
        buffer_lens=[len(r) for r in raw],
    )
    env = frame.SerializeToString()
    return [
        b"".join((_ENV_LEN.pack(len(env)), env, body_bytes)),
        *raw,
    ]


def encode_frame(msg: Dict[str, Any]) -> bytes:
    """Contiguous-frame convenience (tests, fuzzing); the transport
    uses encode_frame_buffers for vectored sends."""
    return b"".join(
        bytes(b) if not isinstance(b, bytes) else b
        for b in encode_frame_buffers(msg)
    )


def decode_frame(data) -> Dict[str, Any]:
    """Frame bytes -> internal message dict. Raises
    ProtocolVersionError on version mismatch (belt-and-braces: the
    handshake already rejects such peers)."""
    view = memoryview(data)
    (env_len,) = _ENV_LEN.unpack_from(view, 0)
    frame = Frame()
    frame.ParseFromString(bytes(view[4 : 4 + env_len]))
    if frame.version != PROTOCOL_VERSION:
        raise ProtocolVersionError(
            f"peer protocol v{frame.version}, this node speaks "
            f"v{PROTOCOL_VERSION}"
        )
    rest = view[4 + env_len :]
    buffers = []
    if frame.buffer_lens:
        # Out-of-band buffers sit after the body; hand pickle
        # zero-copy slices of the receive buffer.
        tail_len = sum(frame.buffer_lens)
        body = rest[: len(rest) - tail_len]
        offset = len(body)
        for blen in frame.buffer_lens:
            buffers.append(rest[offset : offset + blen])
            offset += blen
    else:
        body = rest
    msg: Dict[str, Any] = (
        pickle.loads(body, buffers=buffers) if len(body) else {}
    )
    if frame.method:
        msg["_method"] = frame.method
    msg["_mid"] = frame.mid
    if frame.channel:
        msg["_push"] = frame.channel
    return msg


# -- flat task-spec codec ----------------------------------------------
#
# Task specs are flat dicts of bytes/str/int/float plus two structured
# hot fields (`args`, `returns`) and a handful of cold nested options
# (task_spec.py documents the shape). The batch submit path encodes
# each spec with this dedicated codec instead of pickling the dict, so
# `pickle.dumps` leaves the per-task critical path: the hot fields of
# the common shape ride one struct-packed header + length-prefixed
# blobs, and only the rare cold fields (scheduling_strategy,
# runtime_env, handle_meta, ...) fall back to an embedded pickle.
# A batch frame is the blobs joined with u32 length prefixes — the
# outer RPC pickle then moves ONE bytes object (a memcpy), not N spec
# dicts. `SPEC_MAGIC` is the frame kind byte; bump it when the layout
# changes (decode refuses unknown kinds cleanly).

SPEC_MAGIC = 0xF5  # flat-codec task-spec frame kind, layout v1

#: Field-id table: spec keys with stable 1-byte ids. Order is
#: append-only (ids are wire format); `ray_tpu_torch check` RT104 and
#: tests/test_wire_schema.py keep this table in sync with the fields
#: the submit paths actually ship.
SPEC_FIELDS = [
    # hot header fields (encoded positionally, listed for the table)
    "task_id", "job_id", "kind", "name", "function_key", "args",
    "returns", "resources", "max_retries",
    # tagged tail fields
    "actor_id", "method", "ns_ctx", "num_returns_mode",
    "concurrency_group", "max_restarts", "max_concurrency",
    "release_creation_resources", "namespace", "class_name",
    "handle_meta", "scheduling_strategy", "pg_context", "runtime_env",
    "trace_ctx", "_retries_left", "concurrency_groups",
]
_SPEC_FID = {name: i for i, name in enumerate(SPEC_FIELDS)}
_HOT_FIELDS = frozenset(SPEC_FIELDS[:9])

_SPEC_KINDS = ["normal", "actor_creation", "actor_task", "lease"]
_KIND_CODE = {k: i for i, k in enumerate(_SPEC_KINDS)}

# magic, kind, task_id, job_id, max_retries (signed: -1 = infinite),
# name_len, fkey_len, n_args, n_returns, n_resources
_HOT = _struct.Struct("<BB16s4siHHIHB")
_U32 = _struct.Struct("<I")
_I64 = _struct.Struct("<q")
_F64 = _struct.Struct("<d")

#: Precomputed (field-id, type-tag) prefixes for the tagged tail.
_TAIL_PFX = {
    (name, tag): bytes((fid, tag))
    for name, fid in _SPEC_FID.items()
    for tag in b"NBSTFIDP"
}


class SpecCodecError(Exception):
    """Blob is not a valid flat-codec task spec."""


def encode_spec(spec: Dict[str, Any]) -> bytes:
    """Task-spec dict -> flat blob (no pickle for the hot fields)."""
    name = spec.get("name") or ""
    name_b = name.encode()
    fkey_b = (spec.get("function_key") or "").encode()
    args = spec.get("args") or ()
    returns = spec.get("returns") or ()
    resources = spec.get("resources")
    res_items = list(resources.items()) if resources else []
    parts = [
        _HOT.pack(
            SPEC_MAGIC,
            _KIND_CODE[spec["kind"]],
            spec["task_id"],
            spec["job_id"],
            spec.get("max_retries") or 0,
            len(name_b),
            len(fkey_b),
            len(args),
            len(returns),
            len(res_items),
        ),
        name_b,
        fkey_b,
    ]
    ap = parts.append
    u32p = _U32.pack
    for kind, payload in args:
        ap(b"\x00" if kind == "inline" else b"\x01")
        ap(u32p(len(payload)))
        ap(payload)
    for ret in returns:
        ap(bytes((len(ret),)))
        ap(ret)
    for rk, rv in res_items:
        rkb = rk.encode()
        ap(bytes((len(rkb),)))
        ap(rkb)
        ap(_F64.pack(rv))
    for key, v in spec.items():
        if key in _HOT_FIELDS:
            continue
        t = v.__class__
        if v is None:
            ap(_TAIL_PFX[(key, 78)])  # N
        elif t is bytes:
            ap(_TAIL_PFX[(key, 66)])  # B
            ap(u32p(len(v)))
            ap(v)
        elif t is str:
            vb = v.encode()
            ap(_TAIL_PFX[(key, 83)])  # S
            ap(u32p(len(vb)))
            ap(vb)
        elif t is bool:
            ap(_TAIL_PFX[(key, 84 if v else 70)])  # T / F
        elif t is int:
            ap(_TAIL_PFX[(key, 73)])  # I
            ap(_I64.pack(v))
        elif t is float:
            ap(_TAIL_PFX[(key, 68)])  # D
            ap(_F64.pack(v))
        else:
            # Cold nested option (scheduling_strategy, runtime_env,
            # handle_meta, ...): embedded pickle, length-prefixed —
            # never on the hot normal-task shape.
            pb = pickle.dumps(v, protocol=5)
            ap(_TAIL_PFX[(key, 80)])  # P
            ap(u32p(len(pb)))
            ap(pb)
    return b"".join(parts)


def decode_spec(data: bytes) -> Dict[str, Any]:
    """Flat blob -> task-spec dict. Raises SpecCodecError on a frame
    that is not a v1 flat spec (unknown magic/kind/field)."""
    try:
        (
            magic, kind_code, task_id, job_id, max_retries,
            name_len, fkey_len, n_args, n_returns, n_res,
        ) = _HOT.unpack_from(data, 0)
        if magic != SPEC_MAGIC:
            raise SpecCodecError(f"bad spec magic {magic:#x}")
        pos = _HOT.size
        name = data[pos:pos + name_len].decode()
        pos += name_len
        fkey = data[pos:pos + fkey_len].decode()
        pos += fkey_len
        u32uf = _U32.unpack_from
        args = []
        for _ in range(n_args):
            akind = "inline" if data[pos] == 0 else "ref"
            (ln,) = u32uf(data, pos + 1)
            pos += 5
            args.append((akind, data[pos:pos + ln]))
            pos += ln
        returns = []
        for _ in range(n_returns):
            ln = data[pos]
            pos += 1
            returns.append(data[pos:pos + ln])
            pos += ln
        resources = {}
        for _ in range(n_res):
            kl = data[pos]
            pos += 1
            rk = data[pos:pos + kl].decode()
            pos += kl
            (rv,) = _F64.unpack_from(data, pos)
            pos += 8
            resources[rk] = rv
        spec = {
            "task_id": task_id,
            "job_id": job_id,
            "kind": _SPEC_KINDS[kind_code],
            "name": name,
            "function_key": fkey,
            "args": args,
            "returns": returns,
            "resources": resources,
            "max_retries": max_retries,
        }
        end = len(data)
        fields = SPEC_FIELDS
        while pos < end:
            key = fields[data[pos]]
            tag = data[pos + 1]
            pos += 2
            if tag == 78:  # N
                spec[key] = None
            elif tag == 66:  # B
                (ln,) = u32uf(data, pos)
                pos += 4
                spec[key] = data[pos:pos + ln]
                pos += ln
            elif tag == 83:  # S
                (ln,) = u32uf(data, pos)
                pos += 4
                spec[key] = data[pos:pos + ln].decode()
                pos += ln
            elif tag == 84:  # T
                spec[key] = True
            elif tag == 70:  # F
                spec[key] = False
            elif tag == 73:  # I
                (spec[key],) = _I64.unpack_from(data, pos)
                pos += 8
            elif tag == 68:  # D
                (spec[key],) = _F64.unpack_from(data, pos)
                pos += 8
            elif tag == 80:  # P
                (ln,) = u32uf(data, pos)
                pos += 4
                spec[key] = pickle.loads(data[pos:pos + ln])
                pos += ln
            else:
                raise SpecCodecError(f"unknown tail tag {tag:#x}")
        return spec
    except SpecCodecError:
        raise
    except Exception as e:
        raise SpecCodecError(f"malformed spec blob: {e!r}") from e


def encode_spec_batch(blobs) -> bytes:
    """Join pre-encoded spec blobs into one length-prefixed frame
    payload: the outer RPC pickle moves a single bytes object."""
    pack = _U32.pack
    return b"".join(
        part for blob in blobs for part in (pack(len(blob)), blob)
    )


def split_spec_batch(frame) -> list:
    """Length-prefixed batch payload -> list of raw blobs (framing
    errors raise SpecCodecError; per-blob decode stays the caller's so
    one malformed spec can fail alone instead of killing the batch)."""
    blobs = []
    pos = 0
    end = len(frame)
    u32uf = _U32.unpack_from
    try:
        while pos < end:
            (ln,) = u32uf(frame, pos)
            pos += 4
            if pos + ln > end:
                raise SpecCodecError("truncated batch frame")
            blobs.append(frame[pos:pos + ln])
            pos += ln
    except SpecCodecError:
        raise
    except Exception as e:
        raise SpecCodecError(f"malformed batch frame: {e!r}") from e
    return blobs


def decode_spec_batch(frame) -> list:
    """Length-prefixed batch payload -> list of spec dicts."""
    return [decode_spec(blob) for blob in split_spec_batch(frame)]


# -- per-method argument schemas ---------------------------------------
#
# field spec: name -> type or tuple of accepted types. A leading "?"
# marks the field optional. `dict`/`list` cover nested structures whose
# internals the handlers own. Every method registered on the daemon or
# the worker's direct server MUST appear here (enforced by test).

_num = (int, float)

SCHEMAS: Dict[str, Dict[str, Any]] = {
    # registration / lifecycle
    "register_client": {
        "role": str, "pid": int, "?is_gpu": bool,
        "?direct_address": (str, type(None)), "?entrypoint": str,
    },
    "register_node": {
        "node_id": bytes, "address": str, "resources": dict,
        "?labels": (dict, type(None)),
    },
    "node_heartbeat": {
        "node_id": bytes, "?version": int,
        "?available": (dict, type(None)),
        "?total": (dict, type(None)), "?queued": int,
        "?core_metrics": dict,
    },
    "node_resync": {"node_id": bytes, "actors": list, "objects": list},
    "_disconnect": {},
    "ping": {},
    # direct transport
    "request_lease": {"resources": dict, "?needs_gpu": bool},
    "release_lease": {"lease_id": str},
    "actor_address": {"actor_id": bytes},
    "execute_task": {"spec": dict},
    # Batched direct execution on a leased worker: flat-codec batch
    # payload; the deferred reply carries per-spec outcomes in order.
    "execute_tasks": {"specs": bytes, "count": int},
    # on-demand profiling (reference: dashboard reporter
    # profile_manager — py-spy/memray attach; here in-process)
    "profile": {
        "?kind": str, "?duration_s": _num, "?hz": _num, "?top": int,
        "?start_at": _num,
    },
    "profile_worker": {
        "pid": int, "?kind": str, "?duration_s": _num,
        "?hz": _num, "?top": int, "?node_id": (bytes, type(None)),
        "?start_at": _num,
    },
    # coordinated gang profiling + the head's compile-watch table
    "profile_gang": {
        "?job": (str, type(None)), "?duration_s": _num, "?hz": _num,
    },
    "compile_summary": {},
    # KV
    "kv_put": {
        "key": (str, bytes), "value": bytes, "?ns": str,
        "?overwrite": bool,
    },
    "kv_get": {"key": (str, bytes), "?ns": str},
    "kv_del": {"key": (str, bytes), "?ns": str},
    "kv_keys": {"?prefix": (str, bytes), "?ns": str},
    # object plane
    # Owner-attribution fields on seal/put reports feed the memory
    # ledger: job hex, creating context ("driver"/"task:…"/"actor:…"),
    # and the creator's pid (probed for leak liveness node-locally).
    "put_inline": {
        "oid": bytes, "data": bytes,
        "?owner_job": str, "?owner": str, "?owner_pid": int,
    },
    "object_sealed": {
        "oid": bytes, "size": int, "?node_id": (bytes, type(None)),
        "?owner_job": str, "?owner": str, "?owner_pid": int,
    },
    "seal_error": {"oid": bytes, "error": bytes},
    "get_object": {"oid": bytes},
    # Batched non-blocking get: one round trip resolves N refs (the
    # worker's arg-fetch path); unsealed oids come back as pending
    # markers and the caller falls back to blocking get_object.
    "get_objects": {"oids": list},
    "get_object_meta": {"oid": bytes},
    "pull_object": {"oid": bytes, "?offset": int, "?length": int},
    "delete_object": {"oid": bytes},
    "object_evicted": {"oid": bytes, "?node_id": (bytes, type(None))},
    "spill_request": {"?bytes_needed": int},
    "wait_objects": {
        "oids": list, "num_returns": int,
        "?wait_timeout": (_num + (type(None),)),
    },
    "add_ref": {"oids": list},
    "del_ref": {"oids": list},
    # task plane
    "submit_task": {"spec": dict},
    # Batched submission: `specs` is a flat-codec batch payload
    # (length-prefixed SPEC_MAGIC blobs, see encode_spec_batch) and
    # `count` its spec count; per-spec failures ride back in the reply
    # as {index: error} so error semantics stay per-spec. Ingestion is
    # idempotent by task_id — a retried batch is exactly-once.
    "submit_tasks": {"specs": bytes, "count": int},
    "schedule_task": {"spec": dict},
    "task_finished": {"task_id": bytes, "?had_error": bool},
    "task_done": {
        "task_id": bytes, "?error": (bytes, type(None)),
        "?system_error": (bool, str, type(None)),
    },
    "cancel_task": {"task_id": bytes},
    "cancel_local": {"task_id": bytes},
    "task_event": {"events": list, "?finished": int, "?failed": int},
    "task_counts": {"?finished": int, "?failed": int},
    "span_event": {"spans": list},
    "list_spans": {"?limit": int},
    # actors
    "create_actor": {"spec": dict},
    "submit_actor_task": {"spec": dict},
    "actor_task": {"spec": dict},
    "actor_created": {
        "actor_id": bytes, "node_id": bytes, "?failed": bool,
    },
    "actor_worker_died": {"actor_id": bytes, "?creating": bool},
    "kill_actor": {"actor_id": bytes, "?no_restart": bool},
    "kill_actor_local": {"actor_id": bytes},
    "get_named_actor": {"name": str, "?namespace": str},
    "get_actor_info": {"actor_id": bytes},
    # placement groups
    "create_placement_group": {
        "pg_id": bytes, "bundles": list, "strategy": str,
        "?name": (str, type(None)),
    },
    "placement_group_state": {"pg_id": bytes},
    "placement_group_table": {},
    "remove_placement_group": {"pg_id": bytes},
    "prepare_bundle": {
        "pg_id": bytes, "bundle_index": int, "resources": dict,
    },
    "commit_bundle": {"pg_id": bytes, "bundle_index": int},
    "release_bundle": {"pg_id": bytes, "?bundle_index": int},
    # cluster state / observability
    "cluster_resources": {},
    "available_resources": {},
    "state_summary": {},
    "list_task_events": {"?limit": int},
    "list_nodes": {},
    "list_actors": {},
    "list_objects": {"?limit": int},
    "cluster_load": {},
    "request_resources": {"bundles": list},
    "metrics_record": {
        "records": list,
        "?sender": (str, type(None)),
        "?seq": (int, type(None)),
    },
    "metrics_summary": {},
    # memory ledger: per-node reports up, cluster view down
    "memory_report": {"report": dict},
    "memory_summary": {},
    # data plane (ISSUE 20): transfer matrix + object-location index
    "transfer_summary": {},
    "object_locations": {
        "?oids": list, "?limit": int,
    },
    "metrics_timeseries": {
        "?name": (str, type(None)),
        "?since": _num,
        "?limit": int,
    },
    "event_stats": {},
    # flight recorder / doctor (rings are pulled, never pushed)
    "flight_recorder": {
        "?limit": int, "?kinds": (list, type(None)),
        "?pid": int, "?node_id": (bytes, type(None)),
    },
    "lock_witness": {
        "?pid": int, "?node_id": (bytes, type(None)),
        "?all_workers": bool,
    },
    "inspect": {},
    "worker_inspect": {"?node_id": (bytes, type(None))},
    "step_summary": {"?limit": int, "?records": bool},
    "diagnose": {
        "?hung_task_s": _num, "?straggler_threshold": _num,
        "?capture_stacks": bool, "?limit": int, "?leak_age_s": _num,
        "?compile_storm_threshold": _num,
        "?locality_miss_threshold": _num,
    },
    # pubsub / log streaming
    "subscribe_logs": {"?channels": list},
    "unsubscribe_logs": {},
    "log_batch": {"batches": list, "node": str},
    "publish_event": {"channel": str, "payload": dict},
}


def has_schema(method: str) -> bool:
    """Whether `method` has a registered argument schema. Dispatch
    (rpc.RpcServer._dispatch) warns once per process for methods
    served without one — schema-less dispatch skips typed validation,
    which is exactly the drift `ray_tpu_torch check` (RT104) exists to
    catch."""
    return method in SCHEMAS


def validate(method: str, msg: Dict[str, Any]) -> Optional[str]:
    """Check `msg` against the method's schema. Returns an error
    string, or None when valid. Methods without a registered schema
    pass (the completeness test keeps the registry in sync)."""
    schema = SCHEMAS.get(method)
    if schema is None:
        return None
    for name, types in schema.items():
        optional = name.startswith("?")
        field = name[1:] if optional else name
        if field not in msg:
            if optional:
                continue
            return f"{method}: missing required field {field!r}"
        value = msg[field]
        if not isinstance(value, types):
            expected = (
                types.__name__
                if isinstance(types, type)
                else "/".join(t.__name__ for t in types)
            )
            return (
                f"{method}: field {field!r} expects {expected}, got "
                f"{type(value).__name__}"
            )
    return None
