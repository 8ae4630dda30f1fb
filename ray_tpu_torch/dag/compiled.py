# Copied from ray_tpu/dag/compiled.py (JAX-free): module names read ray_tpu_torch.
"""Compiled DAG execution.

Reference: python/ray/dag/compiled_dag_node.py:691 — compiling an
actor DAG replaces per-call task RPC with persistent per-actor
execution loops connected by channels: each actor blocks on its input
channel(s), runs its bound method, and pushes the result downstream.
One `execute()` then costs channel writes instead of scheduler
round-trips, which is what pipelines (micro-batched inference/training
stages) need.

Protocol records on every channel: ("v", value) | ("e", exception) |
("s", None) for stop. Errors and stop tokens propagate downstream so
one teardown() at the driver drains the whole pipeline.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from ..actor import ActorMethod
from .channels import ChannelTimeoutError, ShmChannel
from .edges import Edge
from .tcp_channel import TcpChannel
from .dag_node import (
    ClassMethodNode,
    DAGNode,
    InputAttributeNode,
    InputNode,
    MultiOutputNode,
)

#: Sentinel key for "the whole input value" (no projection).
_WHOLE = object()

DAG_LOOP_METHOD = "__rt_dag_loop__"


def wait_actor_placements(
    actor_handles, timeout: float = 30.0
) -> Dict[bytes, Optional[str]]:
    """actor_id bytes -> node_id hex for every handle, polling the
    control plane until each actor has been placed (a just-created
    actor may still be leasing a worker). Shared by compiled-DAG
    channel wiring and the MPMD pipeline's edge placement — both need
    the same-node-or-not decision per edge."""
    from .._private.worker import global_worker

    worker = global_worker()
    want = {h.actor_id.binary() for h in actor_handles}
    deadline = time.monotonic() + timeout
    placement: Dict[bytes, Optional[str]] = {}
    while True:
        rows = worker.call("list_actors")["actors"]
        placement = {
            bytes.fromhex(row["actor_id"]): row["node_id"]
            for row in rows
            if bytes.fromhex(row["actor_id"]) in want
        }
        if len(placement) == len(want) and all(
            v is not None for v in placement.values()
        ):
            return placement
        if time.monotonic() > deadline:
            raise RuntimeError(
                "actors not placed within "
                f"{timeout}s (have {len(placement)}/{len(want)})"
            )
        time.sleep(0.05)


def dag_exec_loop(
    instance: Any,
    method_name: str,
    arg_descs: List[Tuple[str, Any]],
    out_channels: List[ShmChannel],
):
    """Runs inside the actor (worker._execute special-cases the
    method name): block on inputs, apply, push downstream."""
    try:
        while True:
            args = []
            stop = False
            error = None
            for kind, value in arg_descs:
                if kind == "const":
                    args.append(value)
                    continue
                tag, payload = value.get()
                if tag == "s":
                    stop = True
                elif tag == "e":
                    error = payload
                else:
                    args.append(payload)
            if stop:
                for chan in out_channels:
                    try:
                        chan.put(("s", None), timeout=5)
                    except Exception:
                        pass
                return "stopped"
            if error is not None:
                for chan in out_channels:
                    chan.put(("e", error))
                continue
            try:
                result = getattr(instance, method_name)(*args)
            except BaseException as e:  # noqa: BLE001 — forwarded
                for chan in out_channels:
                    chan.put(("e", e))
                continue
            for chan in out_channels:
                chan.put(("v", result))
    finally:
        for kind, value in arg_descs:
            if kind == "chan":
                value.close()
        for chan in out_channels:
            chan.close()


class CompiledDAGRef:
    """Future for one execute() (reference: CompiledDAGRef)."""

    def __init__(self, dag: "CompiledDAG", seq: int):
        self._dag = dag
        self._seq = seq
        self._value: Any = None
        self._done = False

    def get(self, timeout: Optional[float] = 30.0):
        if not self._done:
            self._value = self._dag._read_result(self._seq, timeout)
            self._done = True
        if isinstance(self._value, BaseException):
            raise self._value
        return self._value


class CompiledDAG:
    def __init__(self, root: DAGNode, buffer_size_bytes: int = 4 * 2**20):
        self._root = root
        self._buffer = buffer_size_bytes
        self._lock = threading.Lock()
        self._read_mutex = threading.Lock()
        self._submit_mutex = threading.Lock()
        self._next_seq = 0
        self._next_read_seq = 0
        self._results: Dict[int, Any] = {}
        self._torn_down = False
        #: DAG seqs whose execute() raised (no CompiledDAGRef exists
        #: for them): their eventual outputs are read-and-discarded in
        #: _read_result instead of cached forever.
        self._orphan_seqs: set = set()
        #: Tail of a timed-out execute(): [(chan, record, retry_token)]
        #: for input channels that have NOT yet received that
        #: submission's record. The next execute() (or teardown)
        #: finishes these deliveries FIRST — with the channel's retry
        #: token where one exists — so the torn submission lands
        #: exactly once on every channel and the per-channel record
        #: streams stay aligned with the DAG's seq accounting.
        self._pending_inputs: List[tuple] = []
        #: [(channel, projection key | _WHOLE)] in bind order.
        self._input_channels: List[tuple] = []
        self._output_channels: List[ShmChannel] = []
        self._all_channels: List[ShmChannel] = []
        self._loop_refs = []
        self._compile()

    # -- compilation ---------------------------------------------------
    def _compile(self) -> None:
        order = self._root.topological_order()
        inputs = [n for n in order if isinstance(n, InputNode)]
        if len(inputs) != 1:
            raise ValueError(
                "compiled DAGs need exactly one InputNode "
                f"(found {len(inputs)})"
            )
        outputs: List[DAGNode]
        if isinstance(self._root, MultiOutputNode):
            outputs = list(self._root._bound_args)
        else:
            outputs = [self._root]
        actor_nodes: List[ClassMethodNode] = []
        seen_actors = set()
        for node in order:
            if isinstance(
                node, (InputNode, InputAttributeNode, MultiOutputNode)
            ):
                continue
            if not isinstance(node, ClassMethodNode):
                raise TypeError(
                    "compiled DAGs support actor-method nodes only; "
                    f"got {type(node).__name__} (use execute() for "
                    "interpreted task DAGs)"
                )
            key = node.actor_handle.actor_id.binary()
            if key in seen_actors:
                raise ValueError(
                    "an actor may appear in at most one compiled-DAG "
                    "node (its execution loop owns the actor)"
                )
            seen_actors.add(key)
            actor_nodes.append(node)
        for out in outputs:
            if not isinstance(out, ClassMethodNode):
                raise TypeError("DAG outputs must be actor-method nodes")

        # One SPSC channel per (producer -> consumer) edge. Same-node
        # edges ride the shm ring; cross-node edges ride a TCP stream
        # (reference: node_manager.proto:467-469 — mutable objects are
        # pushed to the reader's node when the edge crosses nodes).
        placement = self._actor_placements(actor_nodes)
        driver_node = self._driver_node_id()
        in_descs: Dict[int, List[Tuple[str, Any]]] = {}
        out_chans: Dict[int, List[ShmChannel]] = {
            id(n): [] for n in actor_nodes
        }
        def label(n: ClassMethodNode) -> str:
            return (
                f"{n.method_name}@"
                f"{n.actor_handle.actor_id.hex()[:6]}"
            )

        for node in actor_nodes:
            descs: List[Tuple[str, Any]] = []
            node_placement = placement[node.actor_handle.actor_id.binary()]
            for arg in node._bound_args:
                if isinstance(arg, (InputNode, InputAttributeNode)):
                    chan = self._new_channel(driver_node, node_placement)
                    key = (
                        arg.key
                        if isinstance(arg, InputAttributeNode)
                        else _WHOLE
                    )
                    # Edges wrap the raw channel with per-edge
                    # counters (hops/bytes/wait histograms on the
                    # metrics pipe; doctor folds them) — the channel
                    # itself stays in _all_channels for teardown.
                    # Driver IO edges are counters-only (timed=False):
                    # their blocked time is the caller's own
                    # execute()/get() latency, and the ~2 us timed
                    # path would tax the ~25 us hop (MICROBENCH
                    # dag_hop_per_s). Actor->actor edges keep full
                    # wait timing — that's where a straggler stage
                    # shows.
                    edge = Edge(
                        chan, f"driver->{label(node)}", "in",
                        timed=False,
                    )
                    self._input_channels.append((edge, key))
                    descs.append(("chan", edge))
                elif isinstance(arg, ClassMethodNode):
                    src = placement[arg.actor_handle.actor_id.binary()]
                    chan = self._new_channel(src, node_placement)
                    # Direction "dag" (not the pipeline's
                    # "fwd"/"grad"): an exec loop's blocking input
                    # get also spans IDLE time between execute()
                    # calls, so these waits must not feed the
                    # doctor's straggler-stage heuristic — only the
                    # driver-paced pipeline streams do.
                    edge = Edge(
                        chan, f"{label(arg)}->{label(node)}", "dag"
                    )
                    out_chans[id(arg)].append(edge)
                    descs.append(("chan", edge))
                elif isinstance(arg, DAGNode):
                    raise TypeError(
                        f"unsupported arg node {type(arg).__name__}"
                    )
                else:
                    descs.append(("const", arg))
            if node._bound_kwargs:
                raise TypeError(
                    "compiled DAGs do not support kwargs in bind()"
                )
            in_descs[id(node)] = descs
        for out in outputs:
            src = placement[out.actor_handle.actor_id.binary()]
            chan = self._new_channel(src, driver_node)
            if isinstance(chan, TcpChannel):
                # Publish the driver's reader address NOW: a stage's
                # result put() must be able to complete into the TCP
                # backlog even if the driver never calls get()
                # (teardown-without-get must not wedge the exec loop
                # in rendezvous).
                chan.bind_reader()
            edge = Edge(
                chan, f"{label(out)}->driver", "out", timed=False
            )
            self._output_channels.append(edge)
            out_chans[id(out)].append(edge)

        # Start one persistent loop per actor.
        for node in actor_nodes:
            method = ActorMethod(node.actor_handle, DAG_LOOP_METHOD)
            ref = method.remote(
                node.method_name,
                in_descs[id(node)],
                out_chans[id(node)],
            )
            self._loop_refs.append(ref)

    def _new_channel(self, src_node: Optional[str],
                     dst_node: Optional[str]):
        if src_node is not None and src_node == dst_node:
            chan = ShmChannel(self._buffer)
        else:
            chan = TcpChannel(self._buffer)
        self._all_channels.append(chan)
        return chan

    @staticmethod
    def _driver_node_id() -> Optional[str]:
        from .._private.worker import global_worker

        worker = global_worker()
        node_id = getattr(worker, "node_id", None)
        return node_id.hex() if node_id is not None else None

    @staticmethod
    def _actor_placements(actor_nodes, timeout: float = 30.0):
        return wait_actor_placements(
            [n.actor_handle for n in actor_nodes], timeout=timeout
        )

    # -- execution -----------------------------------------------------
    def execute(
        self, value: Any, *, timeout: Optional[float] = 30.0
    ) -> CompiledDAGRef:
        # Input writes happen under a dedicated submit mutex (ordering
        # across concurrent executes) with a bounded put, so a stalled
        # or dead stage surfaces as ChannelTimeoutError instead of
        # blocking the state lock — which teardown() also needs.
        # Compute every projection BEFORE any channel write: a bad
        # input (missing key) must fail the whole execute, not leave
        # some stages fed and others starved.
        payloads = [
            (chan, value if key is _WHOLE else value[key])
            for chan, key in self._input_channels
        ]
        with self._submit_mutex:
            with self._lock:
                if self._torn_down:
                    raise RuntimeError("compiled DAG was torn down")
            # A previous execute() that timed out mid-fanout left some
            # channels without its record; deliver those first (its
            # DAG seq is already registered, so the streams must catch
            # up before a new record may enter any channel).
            self._drain_pending(timeout)
            with self._lock:
                seq = self._next_seq
                self._next_seq += 1
            for index, (chan, payload) in enumerate(payloads):
                try:
                    chan.put(("v", payload), timeout=timeout)  # rt: noqa[RT203] — _submit_mutex exists to serialize exactly this channel push (one in-flight execute by design)
                except ChannelTimeoutError as e:
                    # Park the undelivered tail: THIS channel resumes
                    # via the retry token (if the transport issued
                    # one — a partially-sent TCP record), the rest
                    # were never attempted. The seq is orphaned (the
                    # caller gets this exception, never a ref), so its
                    # output will be read-and-discarded.
                    self._pending_inputs = [
                        (chan, ("v", payload), getattr(e, "seq", None))
                    ] + [
                        (c, ("v", p), None)
                        for c, p in payloads[index + 1:]
                    ]
                    with self._lock:
                        self._orphan_seqs.add(seq)
                    raise
        return CompiledDAGRef(self, seq)

    def _drain_pending(self, timeout: Optional[float]) -> None:
        """Finish the fanout of a timed-out execute() exactly once per
        channel (caller holds the submit mutex). Raises
        ChannelTimeoutError (keeping the remaining tail parked) if a
        stage still isn't draining."""
        while self._pending_inputs:
            chan, record, token = self._pending_inputs[0]
            try:
                if token is not None:
                    # TcpChannel: resume the exact pending record.
                    chan.put(record, timeout=timeout, seq=token)  # rt: noqa[RT203] — drain runs under the submit mutex by design: pending records must flush in order
                else:
                    chan.put(record, timeout=timeout)  # rt: noqa[RT203] — drain runs under the submit mutex by design: pending records must flush in order
            except ChannelTimeoutError as e:
                self._pending_inputs[0] = (
                    chan, record, getattr(e, "seq", token)
                )
                raise
            self._pending_inputs.pop(0)

    def _read_result(self, seq: int, timeout: Optional[float]):
        """Channel records arrive in submission order. A future whose
        turn hasn't come reads (and caches) results for the earlier
        sequences until it reaches its own."""
        while True:
            with self._lock:
                if seq in self._results:
                    return self._results.pop(seq)
            with self._read_mutex:
                with self._lock:
                    if seq in self._results:
                        return self._results.pop(seq)
                    current = self._next_read_seq
                    if current > seq:
                        raise RuntimeError(
                            f"result {seq} was already consumed"
                        )
                # Commit the read-cursor bump only after the channel
                # read succeeds: a timeout here must leave the
                # seq->record mapping intact for retries.
                result = self._read_channels_once(timeout)
                with self._lock:
                    self._next_read_seq = current + 1
                    if current in self._orphan_seqs:
                        # Output of a timed-out execute(): no ref will
                        # ever claim it — discard instead of caching
                        # it forever.
                        self._orphan_seqs.discard(current)
                        continue
                    if current == seq:
                        return result
                    self._results[current] = result

    def _read_channels_once(self, timeout: Optional[float]):
        values = []
        error: Optional[BaseException] = None
        for chan in self._output_channels:
            tag, payload = chan.get(timeout=timeout)  # rt: noqa[RT203] — _read_mutex serializes exactly this channel read (results are consumed in order)
            if tag == "e":
                error = payload
            elif tag == "s":
                error = RuntimeError("compiled DAG stopped")
            else:
                values.append(payload)
        if error is not None:
            return error
        if isinstance(self._root, MultiOutputNode):
            return values
        return values[0]

    def teardown(self) -> None:
        """Stop every loop and release the channels; the actors return
        to normal method service."""
        with self._lock:
            if self._torn_down:
                return
            self._torn_down = True
        # Stop tokens go through the submit mutex like any execute
        # (bounded puts: a wedged stage can't hang teardown).
        with self._submit_mutex:
            # Best-effort: land any torn execute's records first so a
            # stage never sees stop-then-orphan out of order.
            try:
                self._drain_pending(2.0)
            except Exception:
                pass
            for chan, _key in self._input_channels:
                try:
                    chan.put(("s", None), timeout=5)  # rt: noqa[RT203] — teardown owns the submit mutex so no execute can interleave with the stop frame
                except Exception:
                    pass
        import ray_tpu_torch

        for ref in self._loop_refs:
            try:
                ray_tpu_torch.get(ref, timeout=10)
            except Exception:
                pass
        for chan in self._all_channels:
            chan.close()
            chan.unlink()

    def __del__(self):
        try:
            self.teardown()
        except Exception:
            pass
