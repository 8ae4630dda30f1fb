# Copied from ray_tpu/parallel/schedule.py (pure Python: it imports only typing).
"""Pipeline schedules for MPMD stage gangs (1F1B + interleaved).

`parallel/pipeline.py` keeps the whole pipeline inside one jitted SPMD
program (GPipe over `lax.ppermute`). This module is the OTHER half of
the pipeline story — the multi-program mode the PAPERS.md MPMD paper
argues for: each stage is its own process/gang running its own jitted
fwd/bwd program, activations hop stages over runtime channels, and the
per-stage op ORDER comes from a schedule built here ahead of time.

Everything in this module is pure Python over op tuples — no jax, no
runtime — so schedules are unit-testable (stash bounds, deadlock
freedom) and replayable against measured per-op costs
(`simulate_schedule`), which is how pipebench turns a 1-core CPU run
into a defensible pipeline-efficiency number.

An op is a tuple ``(kind, chunk, mb)``:
  kind   "F" (forward) or "B" (backward)
  chunk  virtual-stage index in [0, n_stages * chunks_per_stage);
         chunk ``c`` lives on physical stage ``c % n_stages``
         (Megatron-style interleaved placement; with
         chunks_per_stage=1, chunk == stage).
  mb     microbatch index in [0, num_microbatches).

Dependencies: F(c, mb) needs F(c-1, mb); B(c, mb) needs B(c+1, mb)
(B of the last chunk needs its own F — the stash). A schedule is a
list of per-PHYSICAL-stage op lists executed strictly in order;
activations/grad records travel on one FIFO edge per (chunk boundary,
direction), so record order on every edge is monotonic in mb by
construction and a receiver can never see a record it is not the
schedule-mandated consumer of.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

Op = Tuple[str, int, int]  # (kind, chunk, mb)


def one_f_one_b(n_stages: int, num_microbatches: int) -> List[List[Op]]:
    """Per-stage op lists for the classic 1F1B (PipeDream-flush)
    schedule: stage s warms up with ``min(n-1-s, m)`` forwards, then
    alternates one-forward-one-backward in steady state, then drains
    the remaining backwards. Stash depth is warmup+1 <= n_stages —
    the whole point vs GPipe's O(num_microbatches) stash."""
    n, m = int(n_stages), int(num_microbatches)
    if n < 1 or m < 1:
        raise ValueError(f"need n_stages>=1, num_microbatches>=1 "
                         f"(got {n}, {m})")
    schedules: List[List[Op]] = []
    for s in range(n):
        warm = min(n - 1 - s, m)
        ops: List[Op] = [("F", s, i) for i in range(warm)]
        f = warm
        for b in range(m - warm):
            ops.append(("F", s, f))
            f += 1
            ops.append(("B", s, b))
        for b in range(m - warm, m):
            ops.append(("B", s, b))
        schedules.append(ops)
    return schedules


def interleaved_1f1b(
    n_stages: int,
    num_microbatches: int,
    chunks_per_stage: int,
) -> List[List[Op]]:
    """Per-physical-stage op lists for the interleaved (virtual-stage)
    schedule: the model is split into ``n_stages * chunks_per_stage``
    chunks, chunk c on stage c % n_stages, and each physical stage
    merges its chunks' 1F1B streams greedily (earliest-ready op first,
    per-chunk order preserved). Shrinks the warmup/cooldown bubble by
    ~1/chunks_per_stage at the cost of more boundary hops.

    chunks_per_stage=1 degenerates to exactly `one_f_one_b`.
    """
    n, m, v = int(n_stages), int(num_microbatches), int(chunks_per_stage)
    if v < 1:
        raise ValueError(f"chunks_per_stage must be >= 1 (got {v})")
    if v == 1:
        return one_f_one_b(n, m)
    V = n * v
    virtual = one_f_one_b(V, m)  # chunk c's own op order
    cursor = [0] * V
    # (kind, chunk, mb) -> completion tick of the unit-cost greedy
    # simulation below; presence = scheduled (list-schedule validity
    # only needs deps to appear earlier in some stage's list).
    done: Dict[Op, float] = {}
    free = [0.0] * n
    schedules: List[List[Op]] = [[] for _ in range(n)]
    remaining = V * len(virtual[0])

    def ready_at(op: Op) -> Optional[float]:
        kind, c, mb = op
        if kind == "F":
            dep = ("F", c - 1, mb) if c > 0 else None
        else:
            dep = ("B", c + 1, mb) if c < V - 1 else ("F", c, mb)
        if dep is None:
            return 0.0
        return done.get(dep)

    while remaining:
        progressed = False
        # Offer the least-loaded stage first so the merge stays fair.
        for s in sorted(range(n), key=lambda i: free[i]):
            best: Optional[Tuple[float, int, Op]] = None
            for c in range(s, V, n):
                if cursor[c] >= len(virtual[c]):
                    continue
                op = virtual[c][cursor[c]]
                at = ready_at(op)
                if at is None:
                    continue
                key = (at, c)
                if best is None or key < (best[0], best[1]):
                    best = (at, c, op)
            if best is None:
                continue
            at, c, op = best
            start = max(free[s], at)
            done[op] = start + 1.0
            free[s] = start + 1.0
            cursor[c] += 1
            schedules[s].append(op)
            remaining -= 1
            progressed = True
        if not progressed:
            raise RuntimeError(
                "interleaved schedule construction deadlocked "
                f"(n={n}, m={m}, v={v}) — this is a bug"
            )
    return schedules


def max_stash_depth(ops: Sequence[Op]) -> int:
    """Peak number of stashed forward activations one stage's op list
    holds (every F stashes its input until the matching B retires it).
    The 1F1B invariant: <= n_stages per chunk."""
    live = 0
    peak = 0
    for kind, _c, _mb in ops:
        if kind == "F":
            live += 1
            peak = max(peak, live)
        else:
            live -= 1
    return peak


def validate_schedule(
    schedules: Sequence[Sequence[Op]],
    n_stages: int,
    num_microbatches: int,
    chunks_per_stage: int = 1,
    channel_depth: Optional[int] = None,
) -> None:
    """Raise if the per-stage op lists are not a complete, deadlock-
    free execution of the pipeline: every (F, B) x chunk x mb op
    appears exactly once on its owning stage, per-chunk mb order is
    FIFO in both directions, and in-order execution of the lists never
    blocks on an op no earlier list position produces. Used by tests
    AND by the driver at build time — a malformed schedule must die at
    construction, not hang the gang.

    With ``channel_depth`` the check additionally models BOUNDED
    edges: a send blocks while its edge holds `depth` unconsumed
    records (exactly the runtime's ring-capacity backpressure). For
    fixed op lists over blocking FIFO edges, deadlock is
    timing-independent (a Kahn network), so this bounded execution
    decides it exactly — an interleaved schedule too deep for the
    configured depth dies HERE, not as an all-stages hang at
    hop-timeout."""
    n, m, v = int(n_stages), int(num_microbatches), int(chunks_per_stage)
    V = n * v
    want = {
        (kind, c, mb)
        for kind in ("F", "B")
        for c in range(V)
        for mb in range(m)
    }
    seen = set()
    for s, ops in enumerate(schedules):
        last_mb: Dict[Tuple[str, int], int] = {}
        for op in ops:
            kind, c, mb = op
            if c % n != s:
                raise ValueError(f"stage {s} scheduled foreign {op}")
            if op in seen:
                raise ValueError(f"duplicate op {op}")
            seen.add(op)
            prev = last_mb.get((kind, c), -1)
            if mb <= prev:
                raise ValueError(
                    f"stage {s} {kind} chunk {c}: mb {mb} after {prev} "
                    "(edge FIFO order violated)"
                )
            last_mb[(kind, c)] = mb
    if seen != want:
        missing = sorted(want - seen)[:4]
        raise ValueError(f"incomplete schedule; missing {missing}...")
    # In-order execution must make progress at every scan: classic
    # list-schedule deadlock check, with optional bounded edges.
    # Each op is two phases matching the runtime: (recv input,
    # compute) then (send output — blocks while the edge is full).
    depth: Optional[int] = None
    if channel_depth is not None:
        if channel_depth != int(channel_depth):
            raise ValueError(
                f"channel_depth must be integral (got {channel_depth})"
            )
        depth = int(channel_depth)
        if depth < 1:
            raise ValueError(
                f"channel_depth must be >= 1 (got {depth})"
            )
    # edge key: (boundary chunk index, direction) -> records in flight
    in_flight: Dict[Tuple[int, str], int] = {}

    def op_io(op: Op):
        """(recv_edge | None, send_edge | None) for an op."""
        kind, c, mb = op
        if kind == "F":
            recv = (c - 1, "fwd") if c > 0 else None
            send = (c, "fwd") if c < V - 1 else None
        else:
            recv = (c, "grad") if c < V - 1 else None
            send = (c - 1, "grad") if c > 0 else None
        return recv, send

    cursor = [0] * len(schedules)
    pending_send: List[Optional[Tuple[int, str]]] = [None] * len(
        schedules
    )
    done: set = set()
    total = sum(len(ops) for ops in schedules)
    completed = 0
    while completed < total:
        progressed = False
        for s, ops in enumerate(schedules):
            while cursor[s] < len(ops):
                op = ops[cursor[s]]
                kind, c, mb = op
                if pending_send[s] is not None:
                    # Mid-op: computed, blocked on a full edge.
                    edge = pending_send[s]
                    if depth is not None and in_flight.get(
                        edge, 0
                    ) >= depth:
                        break
                    in_flight[edge] = in_flight.get(edge, 0) + 1
                    pending_send[s] = None
                    done.add(op)
                    cursor[s] += 1
                    completed += 1
                    progressed = True
                    continue
                if kind == "F":
                    dep = ("F", c - 1, mb) if c > 0 else None
                else:
                    dep = ("B", c + 1, mb) if c < V - 1 else ("F", c, mb)
                if dep is not None and dep not in done:
                    break
                recv, send = op_io(op)
                if recv is not None:
                    # The dep's completion guarantees the record was
                    # delivered (dep in done covers its send phase).
                    in_flight[recv] = in_flight.get(recv, 0) - 1
                if send is not None and depth is not None and \
                        in_flight.get(send, 0) >= depth:
                    pending_send[s] = send
                    progressed = True  # the recv freed edge space
                    break
                if send is not None:
                    in_flight[send] = in_flight.get(send, 0) + 1
                done.add(op)
                cursor[s] += 1
                completed += 1
                progressed = True
        if not progressed:
            stuck = [
                (s, schedules[s][cursor[s]])
                for s in range(len(schedules))
                if cursor[s] < len(schedules[s])
            ]
            hint = (
                f" under channel_depth={depth} — raise "
                "pipeline_channel_depth or lower chunks_per_stage"
                if depth is not None
                else ""
            )
            raise ValueError(
                f"schedule deadlocks at {stuck[:4]}{hint}"
            )


def theoretical_efficiency(
    n_stages: int, num_microbatches: int, chunks_per_stage: int = 1
) -> float:
    """The bubble bound: fraction of each stage's ideal wall spent
    computing — m / (m + (n-1)/v) with balanced stages (the classic
    m/(m+n-1) at v=1; interleaving shrinks the fill/drain ramp by
    1/v)."""
    n, m, v = int(n_stages), int(num_microbatches), int(chunks_per_stage)
    return m / (m + (n - 1) / v)


def simulate_schedule(
    schedules: Sequence[Sequence[Op]],
    op_cost_s,
    hop_cost_s: float = 0.0,
) -> dict:
    """Replay per-stage op lists as a discrete-event simulation with
    each stage on its own executor: op start = max(stage free, inputs
    ready + hop), strictly in list order. `op_cost_s(kind, chunk, mb)`
    supplies each op's duration (pipebench feeds MEASURED per-op times
    from the real multi-stage run, so the result is a measurement-
    driven account of what the schedule costs when stages do not
    time-share a core — the honest pipeline-efficiency number a
    1-core CI box can produce, committed alongside the raw wall
    numbers it was derived from).

    Returns {wall_s, busy_s (per stage), idle_s (per stage),
    efficiency} where efficiency = total busy / (n_stages * wall) —
    directly comparable to `theoretical_efficiency`.
    """
    n = len(schedules)
    cursor = [0] * n
    free = [0.0] * n
    busy = [0.0] * n
    done: Dict[Op, float] = {}
    total = sum(len(ops) for ops in schedules)
    V = max((c for ops in schedules for _k, c, _m in ops), default=0) + 1
    completed = 0
    while completed < total:
        progressed = False
        for s in range(n):
            while cursor[s] < len(schedules[s]):
                op = schedules[s][cursor[s]]
                kind, c, mb = op
                if kind == "F":
                    dep = ("F", c - 1, mb) if c > 0 else None
                else:
                    dep = ("B", c + 1, mb) if c < V - 1 else ("F", c, mb)
                ready = 0.0
                if dep is not None:
                    if dep not in done:
                        break
                    ready = done[dep]
                    # Cross-stage deps pay the channel hop; the
                    # last-chunk B's dep is its own stash (free).
                    if dep[1] % n != s:
                        ready += hop_cost_s
                cost = float(op_cost_s(kind, c, mb))
                start = max(free[s], ready)
                done[op] = start + cost
                free[s] = start + cost
                busy[s] += cost
                cursor[s] += 1
                completed += 1
                progressed = True
        if not progressed:
            raise RuntimeError("simulate_schedule: schedule deadlocks")
    wall = max(free) if n else 0.0
    return {
        "wall_s": wall,
        "busy_s": busy,
        "idle_s": [wall - b for b in busy],
        "efficiency": (
            sum(busy) / (n * wall) if wall > 0 else 0.0
        ),
    }


def partition_layers(
    n_layers: int,
    n_chunks: int,
    layer_ms: Optional[Sequence[float]] = None,
    *,
    embed_ms: float = 0.0,
    head_ms: float = 0.0,
) -> List[Tuple[int, int]]:
    """Contiguous [start, end) layer ranges per chunk minimizing the
    bottleneck chunk cost. `layer_ms` is per-layer cost (uniform when
    omitted — e.g. bench.py's measured `layer_ms` applies to every
    layer of a homogeneous stack); `embed_ms` loads chunk 0 and
    `head_ms` the last chunk — the asymmetric ends the
    `fixed_ms_breakdown` numbers name (embed + lm_head/loss), so a
    balanced partition gives the end chunks FEWER layers instead of
    pretending the stack is symmetric.

    DP over split points (O(L^2 * C)): exact bottleneck minimum, and
    L, C are tiny (<=128 layers, <=32 chunks)."""
    L, C = int(n_layers), int(n_chunks)
    if C < 1 or L < 0:
        raise ValueError(f"bad partition request ({L} layers, {C} chunks)")
    if C > L and L > 0:
        raise ValueError(f"more chunks ({C}) than layers ({L})")
    costs = (
        [float(c) for c in layer_ms]
        if layer_ms is not None
        else [1.0] * L
    )
    if len(costs) != L:
        raise ValueError(f"layer_ms has {len(costs)} entries for {L} layers")
    prefix = [0.0]
    for c in costs:
        prefix.append(prefix[-1] + c)

    def span(i: int, j: int, chunk: int) -> float:
        cost = prefix[j] - prefix[i]
        if chunk == 0:
            cost += float(embed_ms)
        if chunk == C - 1:
            cost += float(head_ms)
        return cost

    # best[c][j]: minimal bottleneck for layers [0, j) in chunks
    # [0..c]; parent pointers rebuild the split.
    INF = float("inf")
    best = [[INF] * (L + 1) for _ in range(C)]
    parent = [[0] * (L + 1) for _ in range(C)]
    for j in range(L + 1):
        best[0][j] = span(0, j, 0)
    for c in range(1, C):
        for j in range(L + 1):
            for i in range(j + 1):
                cand = max(best[c - 1][i], span(i, j, c))
                if cand < best[c][j]:
                    best[c][j] = cand
                    parent[c][j] = i
    bounds: List[Tuple[int, int]] = []
    j = L
    for c in range(C - 1, 0, -1):
        i = parent[c][j]
        bounds.append((i, j))
        j = i
    bounds.append((0, j))
    bounds.reverse()
    return bounds
