"""MPMD pipeline-parallel training: 1F1B stage actors over channels
(PyTorch port of `ray_tpu/train/mpmd_pipeline.py`).

`train/pipeline_step.py` runs GPipe inside one SPMD program over a
process group. This module is the multi-program mode: the layer stack
is partitioned into chunks (`parallel/schedule.py`'s `partition_layers`,
bounds may be uneven), each physical stage is an actor of the port's
runtime that holds its own chunks (`_Chunk`: the port's `LlamaLayer`s
lo:hi, the embedding on the first chunk, the final norm and lm_head on
the last) and runs them eagerly, and activations and their gradients
ride channel edges wired once at build (`dag/edges.py`: shm on one
host, TCP across hosts, bounded capacity as backpressure) under a 1F1B
schedule (`interleaved_1f1b`): warmup fills, steady state alternates one
forward and one backward so the activation stash stays O(n_stages),
cooldown drains, then every stage applies its local optimizer to its
own chunks. No cross-stage traffic exists beyond the boundary hops.

Numerics contract (the parity tests pin it against the JAX package):
with the same parameters, the accumulated gradient equals the
single-program one. Each microbatch's backward uses the objective
``nll_sum_mb / count_total + (moe_aux_weight / num_mb) * aux_mb``,
whose sum over microbatches is the single-program loss
``nll_total / count_total + moe_aux_weight * aux_total / num_mb``
(count_total is known up front: targets are host data). The backward
is remat-style: a stage stashes only its chunk's input and recomputes
the chunk under `torch.enable_grad()` before `torch.autograd.grad`, so
the stash holds at most `stash_bound` microbatch activations. Inside
the chunk `cfg.remat` applies per layer as in the plain step
(`LlamaLayer.forward`): under remat "full" each layer of a recomputed
chunk runs its forward once more in the backward, as the JAX package's
checkpointed scan body does inside its vjp.

Optimizer locality: the update runs per stage on that stage's chunks,
with the port's optimizer interface (`train_step.AdamW`: `init(params)`,
`apply(params, grads, state, grad_norm)`). A global-norm clip sees only
the local shard: its norm is the stage's own.

Placement: `device="cuda"` (the default) gives each stage actor a share
of the node's cards, ``num_gpus = min(1, cards / n_stages)`` (two stages
on one card take half each), and the stage binds card
``stage % (cards it sees)`` itself; `device="cpu"` keeps CPU-only actors
(the tests). A stage asked for the card never carries on on the CPU.
Activations cross the edges as CPU tensors (the channels pickle their
records; a pickled CUDA tensor would come back on the sender's card
index), moved to the stage's device after `get`.

Compile watch: as in the JAX package, every stage program is registered
by name, `mpmd.s<stage>.<key>` with key `fwd:<chunk>` (a non-last
chunk's forward), `bwd:<chunk>` (a chunk's recompute and backward, the
last chunk's objective included), `acc` (the gradient accumulation) and
`opt` (the stage's optimizer step): each runs one signature per
microbatch geometry, and a drifting microbatch shape is a storm `doctor`
names.
"""

from __future__ import annotations

import os
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from .. import api as rt
from .._private.config import Config
from ..dag.channels import ShmChannel
from ..dag.edges import Edge
from ..dag.tcp_channel import TcpChannel
from ..exceptions import GetTimeoutError, RayTpuError
from ..models.llama import (
    LlamaConfig,
    LlamaLayer,
    embed_tokens,
    init_params,
    masked_xent,
    model_norm,
)
from ..ops.norms import rotary_embedding
from ..parallel.schedule import (
    interleaved_1f1b,
    max_stash_depth,
    partition_layers,
    theoretical_efficiency,
    validate_schedule,
)
from .train_step import global_norm

__all__ = ["MPMDPipeline", "MPMDPipelineError"]


class MPMDPipelineError(RayTpuError):
    """A pipeline step failed (stage death, channel timeout, protocol
    desync). The pipeline is broken afterwards — build a new one."""


# ---------------------------------------------------------------------------
# stage programs (eager, inside the stage actor)
# ---------------------------------------------------------------------------

class _Chunk(nn.Module):
    """One chunk of the layer stack: `n_layers` `LlamaLayer`s, and the
    embedding if it is the first chunk, the final norm and lm_head if it
    is the last. Parameter names are a `Llama`'s with the layers counted
    from 0. RoPE is recomputed from absolute positions in each call, so
    an edge carries the activation alone."""

    def __init__(self, cfg: LlamaConfig, n_layers: int, first: bool,
                 last: bool, device):
        super().__init__()
        self.cfg = cfg
        self.first, self.last = first, last
        kw = dict(device=device, dtype=cfg.dtype)
        if first:
            self.embed = nn.Embedding(cfg.vocab_size, cfg.dim, **kw)
        self.layers = nn.ModuleList(
            LlamaLayer(cfg, device=device) for _ in range(n_layers))
        if last:
            self.final_norm = nn.Parameter(torch.ones(cfg.dim, **kw))
            self.lm_head = nn.Linear(cfg.dim, cfg.vocab_size, bias=False,
                                     **kw)

    def forward(self, x):
        """(y, aux): the chunk's output activation and its layers' MoE
        aux loss (0 for dense layers). `x` is token ids for the first
        chunk, an activation [b, t, dim] otherwise."""
        cfg = self.cfg
        b, t = x.shape[0], x.shape[1]
        if self.first:
            x = embed_tokens(cfg, self, x)
        positions = torch.arange(t, device=x.device).expand(b, t)
        cos, sin = rotary_embedding(positions, cfg.head_dim, cfg.rope_theta,
                                    cfg.rope_scaling)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for layer in self.layers:
            x, layer_aux = layer(x, cos, sin)
            aux = aux + layer_aux
        return x, aux

    def objective(self, x, targets, inv_count: float, aux_scale: float):
        """The last chunk's objective: its layers, the final norm,
        lm_head and the masked xent, scaled so that the microbatches'
        objectives sum to the single-program loss. Returns
        (objective, (nll, count, aux))."""
        h, aux = self(x)
        h = model_norm(self.cfg, h, self.final_norm)
        nll, count = masked_xent(self.lm_head(h).float(), targets)
        return nll * inv_count + aux_scale * aux, (nll, count, aux)


def _chunk_vjp(chunk: _Chunk, params: List[torch.Tensor], x, gy,
               aux_ct: float, wrt_input: bool):
    """Recompute `chunk` from its stashed input `x`, then the gradient of
    <y, gy> + aux_ct * aux with respect to `params` (and to `x` if
    `wrt_input`). The cotangent of aux goes in in aux's dtype, as the
    JAX package passes it. Returns (param grads, dx or None)."""
    if wrt_input:
        x = x.detach().requires_grad_()
    with torch.enable_grad():
        y, aux = chunk(x)
        outs, cts = [y], [gy]
        if aux.requires_grad:  # dense layers: aux is a constant 0
            outs.append(aux)
            cts.append(torch.full_like(aux, aux_ct))
        grads = _grads(outs, params + ([x] if wrt_input else []), cts)
    dx = grads.pop() if wrt_input else None
    return grads, dx


@torch.no_grad()
def _chunk_forward(chunk: _Chunk, x):
    """A non-last chunk's forward: (y, aux)."""
    return chunk(x)


def _last_chunk_vjp(chunk: _Chunk, params: List[torch.Tensor], x, targets,
                    inv_count: float, aux_scale: float):
    """The last chunk's forward inside its backward: its objective, the
    gradient of it with respect to `params` and `x`, and the loss pieces.
    Returns (param grads, dx, objective, nll, count, aux)."""
    x = x.detach().requires_grad_()
    with torch.enable_grad():
        obj, (nll, cnt, aux) = chunk.objective(x, targets, inv_count,
                                               aux_scale)
        *dp, dx = _grads(obj, params + [x])
    return dp, dx, obj, nll, cnt, aux


def _grads(outs, inputs: List[torch.Tensor], cts=None) -> List[torch.Tensor]:
    """`torch.autograd.grad`, with zeros for an input the outputs do not
    reach (as `jax.vjp` gives)."""
    grads = torch.autograd.grad(outs, inputs, cts, allow_unused=True)
    return [torch.zeros_like(i) if g is None else g
            for g, i in zip(grads, inputs)]


def _total(parts: List[torch.Tensor]) -> float:
    """The sum of 0-dim device tensors, read once."""
    if not parts:
        return 0.0
    return float(torch.stack([p.double() for p in parts]).sum())


# ---------------------------------------------------------------------------
# the stage actor
# ---------------------------------------------------------------------------

class _PipelineStage:
    """One physical pipeline stage: owns its chunks' parameters and
    optimizer state, its channel endpoints, and executes its slice of
    the 1F1B schedule per `run_step` call."""

    def __init__(
        self,
        stage_idx: int,
        n_stages: int,
        cfg,
        chunk_specs: Sequence[Tuple[int, int, int]],
        n_chunks_total: int,
        num_microbatches: int,
        ops: Sequence[Tuple[str, int, int]],
        optimizer_factory: Optional[Callable],
        hop_timeout_s: float,
        device: str,
        num_threads: int,
    ):
        self.stage = int(stage_idx)
        self.n_stages = int(n_stages)
        self.cfg = cfg
        self.chunk_specs = [tuple(s) for s in chunk_specs]
        self.V = int(n_chunks_total)
        self.num_mb = int(num_microbatches)
        self.ops = [tuple(op) for op in ops]
        self.hop_timeout = float(hop_timeout_s)
        self.aux_scale = cfg.moe_aux_weight / self.num_mb
        if device == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    f"stage {self.stage} was asked for the card and sees "
                    "no CUDA device")
            # A GPU worker sees every card of its node: bind our own.
            self.device = torch.device(
                "cuda", self.stage % torch.cuda.device_count())
            torch.cuda.set_device(self.device)
        else:
            self.device = torch.device(device)
            torch.set_num_threads(max(1, int(num_threads)))
        self._optimizer = (
            optimizer_factory() if optimizer_factory else None
        )
        self._chunks: Dict[int, _Chunk] = {}
        self._params: Dict[int, List[torch.Tensor]] = {}
        self._opt_state = None
        self._edges: Dict[str, Dict[int, Optional[Edge]]] = {}
        # Every stage program registers with the compile watcher by
        # name (mpmd.s<stage>.<key>, bounded by the pipeline topology):
        # each runs one signature from warm-up on.
        from .._private import compile_watch

        def _program(key: str, fn):
            return compile_watch.instrument(f"mpmd.s{self.stage}.{key}", fn)

        self._programs: Dict[str, Callable] = {}
        for c, _lo, _hi in self.chunk_specs:
            if c == self.V - 1:
                self._programs[f"bwd:{c}"] = _program(f"bwd:{c}",
                                                      _last_chunk_vjp)
            else:
                self._programs[f"fwd:{c}"] = _program(f"fwd:{c}",
                                                      _chunk_forward)
                self._programs[f"bwd:{c}"] = _program(f"bwd:{c}", _chunk_vjp)
        self._programs["acc"] = _program("acc", torch._foreach_add_)
        if self._optimizer is not None:
            optimizer = self._optimizer
            self._programs["opt"] = _program(
                "opt", lambda params, grads, state: optimizer.apply(
                    params, grads, state, global_norm(grads)))
        # Session wiring: stage rank telemetry rides the same
        # per-(step, rank) records gang training uses, so doctor /
        # goodput / gang-skew read pipeline stages like data ranks.
        from .session import TrainContext, init_session

        init_session(
            TrainContext(
                world_rank=self.stage, world_size=self.n_stages
            )
        )

    # -- wiring --------------------------------------------------------
    def wire(self, fwd_in, fwd_out, bwd_in, bwd_out) -> int:
        """Install this stage's channel endpoints (dict: chunk ->
        Edge | None). Called once at build; edges are REUSED across
        every subsequent step — wiring is off the step path."""
        self._edges = {
            "fwd_in": dict(fwd_in),
            "fwd_out": dict(fwd_out),
            "bwd_in": dict(bwd_in),
            "bwd_out": dict(bwd_out),
        }
        return self.stage

    def set_params(self, chunk_states: Dict[int, Dict[str, torch.Tensor]]
                   ) -> int:
        """Build this stage's chunks on its device from their state
        dicts (CPU tensors, layers counted from 0 in each chunk), and the
        optimizer state over all of them."""
        self._chunks, self._params = {}, {}
        for c, lo, hi in self.chunk_specs:
            chunk = _Chunk(self.cfg, hi - lo, first=c == 0,
                           last=c == self.V - 1, device=self.device)
            chunk.load_state_dict(chunk_states[c])
            self._chunks[c] = chunk
            self._params[c] = list(chunk.parameters())
        if self._optimizer is not None:
            self._opt_state = self._optimizer.init(self._all_params())
        return self.stage

    def _all_params(self) -> List[torch.Tensor]:
        return [p for c, _lo, _hi in self.chunk_specs
                for p in self._params[c]]

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- the step ------------------------------------------------------
    def run_step(
        self,
        step_index: int,
        tokens_mbs: Optional[List[torch.Tensor]] = None,
        targets_mbs: Optional[List[torch.Tensor]] = None,
    ) -> dict:
        """Execute this stage's 1F1B op list once: recv/compute/send
        per op, accumulate grads, then apply the local optimizer
        shard. Returns the loss pieces, the per-op times and the edges'
        hop and wait counts."""
        t_wall0 = time.monotonic()
        last_c = self.V - 1
        dev = self.device
        stash: Dict[Tuple[int, int], torch.Tensor] = {}
        stash_peak = 0
        grads: Dict[int, List[torch.Tensor]] = {}
        op_ms: Dict[str, List[float]] = {}
        # Loss pieces stay device-side until the schedule drains —
        # an .item() per op would insert m extra D2H syncs into the
        # schedule's critical path.
        nll_parts: List[torch.Tensor] = []
        cnt_parts: List[torch.Tensor] = []
        aux_parts: List[torch.Tensor] = []
        obj_parts: List[torch.Tensor] = []
        inv_count = None
        if targets_mbs is not None:
            count = float(
                sum(int((t >= 0).sum()) for t in targets_mbs)
            )
            inv_count = 1.0 / max(count, 1.0)

        def _time(key: str, t0: float) -> None:
            op_ms.setdefault(key, []).append(
                (time.monotonic() - t0) * 1e3
            )

        for kind, c, mb in self.ops:
            chunk = self._chunks[c]
            if kind == "F":
                if c == 0:
                    x = tokens_mbs[mb].to(dev)
                else:
                    x = self._recv("fwd_in", c, ("F", c, mb))
                stash[(c, mb)] = x
                stash_peak = max(stash_peak, len(stash))
                if c != last_c:
                    t0 = time.monotonic()
                    y, aux = self._programs[f"fwd:{c}"](chunk, x)
                    y = y.cpu()  # waits for the chunk
                    _time(f"F:{c}", t0)
                    aux_parts.append(aux)
                    self._send("fwd_out", c, ("F", c + 1, mb), y)
                # Last chunk: forward happens inside its backward
                # (remat) — F just lands the stash.
            else:  # B
                x = stash.pop((c, mb))
                params = self._params[c]
                if c == last_c:
                    t0 = time.monotonic()
                    dp, dx, obj, nll, cnt, aux = self._programs[f"bwd:{c}"](
                        chunk, params, x, targets_mbs[mb].to(dev),
                        inv_count, self.aux_scale)
                    dx = dx.cpu()
                    _time(f"B:{c}", t0)
                    nll_parts.append(nll.detach())
                    cnt_parts.append(cnt)
                    aux_parts.append(aux.detach())
                    obj_parts.append(obj.detach())
                    if c > 0:
                        self._send(
                            "bwd_out", c, ("B", c - 1, mb), dx
                        )
                else:
                    gy = self._recv("bwd_in", c, ("B", c, mb))
                    t0 = time.monotonic()
                    dp, dx = self._programs[f"bwd:{c}"](
                        chunk, params, x, gy, self.aux_scale, c > 0)
                    if c == 0:
                        self._sync()
                    else:
                        dx = dx.cpu()
                    _time(f"B:{c}", t0)
                    if c > 0:
                        self._send("bwd_out", c, ("B", c - 1, mb), dx)
                if c in grads:
                    self._programs["acc"](grads[c], dp)
                else:
                    grads[c] = list(dp)
        if stash:
            raise MPMDPipelineError(
                f"stage {self.stage}: {len(stash)} unretired "
                "stashes after the schedule — schedule bug"
            )
        opt_ms = 0.0
        if self._optimizer is not None:
            t0 = time.monotonic()
            flat = [g for c, _lo, _hi in self.chunk_specs for g in grads[c]]
            self._programs["opt"](self._all_params(), flat, self._opt_state)
            self._sync()
            opt_ms = (time.monotonic() - t0) * 1e3

        nll_total = _total(nll_parts)
        cnt_total = _total(cnt_parts)
        aux_total = _total(aux_parts)
        obj_total = _total(obj_parts)
        wall_ms = (time.monotonic() - t_wall0) * 1e3
        busy_ms = (
            sum(sum(v) for v in op_ms.values()) + opt_ms
        )
        edges = [
            e.take_stats()
            for group in self._edges.values()
            for e in group.values()
            if e is not None
        ]
        # Session heartbeat: one per-(step, rank=stage) record with
        # send_wait/recv_wait phases (billed by Edge) riding the
        # metrics pipe — the doctor's bubble attribution.
        from .session import get_session

        session = get_session()
        if session is not None:
            session.report(
                {"step_ms": busy_ms, "pipeline_stage": self.stage}
            )
        return {
            "stage": self.stage,
            "nll": nll_total,
            "count": cnt_total,
            "aux": aux_total,
            "objective": obj_total,
            "busy_ms": round(busy_ms, 3),
            "opt_ms": round(opt_ms, 3),
            "wall_ms": round(wall_ms, 3),
            "op_ms": {
                k: [round(v, 3) for v in vals]
                for k, vals in op_ms.items()
            },
            "edges": edges,
            "stash_peak": stash_peak,
        }

    def _recv(self, group: str, chunk: int, want: tuple) -> torch.Tensor:
        """The next record of an edge, checked against the schedule; its
        payload (a CPU tensor) on this stage's device."""
        edge = self._edges[group][chunk]
        tag, payload = edge.get_value(timeout=self.hop_timeout)
        if tuple(tag) != want:
            raise MPMDPipelineError(
                f"stage {self.stage} edge {edge.name}: got record "
                f"{tag}, schedule expected {want}"
            )
        return payload.to(self.device)

    def _send(self, group: str, chunk: int, tag: tuple,
              payload: torch.Tensor) -> None:
        edge = self._edges[group][chunk]
        edge.put_value((tag, payload), timeout=self.hop_timeout)

    # -- params / checkpoints -----------------------------------------
    def get_params(self) -> Dict[int, Dict[str, torch.Tensor]]:
        """Each chunk's state dict, as CPU tensors."""
        return {
            c: {k: v.detach().cpu() for k, v in chunk.state_dict().items()}
            for c, chunk in self._chunks.items()
        }

    def _state(self) -> Dict[str, Any]:
        """What a checkpoint holds: each chunk's state dict (by chunk
        index), and the optimizer state with each list of per-parameter
        tensors keyed by parameter name. Its tensors are the live ones,
        so restoring into it restores in place."""
        names = [f"{c}.{n}" for c, _lo, _hi in self.chunk_specs
                 for n, _ in self._chunks[c].named_parameters()]
        opt = {k: dict(zip(names, v)) if isinstance(v, list) else v
               for k, v in (self._opt_state or {}).items()}
        return {"params": {str(c): chunk.state_dict()
                           for c, chunk in self._chunks.items()},
                "opt_state": opt}

    def save(self, root: str, step: int,
             async_save: bool = True) -> str:
        from .checkpoint import save_checkpoint

        path = os.path.join(
            root, f"step-{step:08d}", f"stage-{self.stage}"
        )
        save_checkpoint(
            path,
            self._state(),
            metadata={
                "stage": self.stage,
                "chunks": [c for c, _l, _h in self.chunk_specs],
                "step": int(step),
            },
            async_save=async_save,
        )
        return path

    def wait_ckpt(self) -> None:
        """Durability barrier, stage-side: pending async saves must
        persist before the driver trusts the checkpoint."""
        from .checkpoint import wait_for_checkpoints

        wait_for_checkpoints()

    def restore(self, root: str, step: int) -> int:
        from .checkpoint import restore_checkpoint

        path = os.path.join(
            root, f"step-{step:08d}", f"stage-{self.stage}"
        )
        state = restore_checkpoint(path, self._state())
        # Tensors were restored in place; Python values are taken back.
        for k, v in state["opt_state"].items():
            if not isinstance(v, dict):
                self._opt_state[k] = v
        return self.stage

    def take_launch_counts(self) -> Dict[str, int]:
        """The flash kernels' launches in this stage's process since the
        last call (`ops.attention.LAUNCHES`); the counts restart at 0."""
        from ..ops import attention

        counts = dict(attention.LAUNCHES)
        attention.reset_launch_counts()
        return counts

    def compile_counts(self) -> Dict[str, Dict[str, int]]:
        """Each of this stage's programs (`mpmd.s<stage>.<key>` by key):
        its compile-watch counts in this stage's process (`compiles`,
        `distinct_shapes`) and the signatures this stage's own program
        has seen (`signatures`)."""
        return {key: dict(prog.stats(), signatures=prog.signatures())
                for key, prog in self._programs.items()}

    def peak_memory(self) -> Dict[str, Any]:
        """This stage's device and its peak of allocated memory since
        the last call, in bytes (0 on the CPU); the peak restarts."""
        peak = 0
        if self.device.type == "cuda":
            peak = torch.cuda.max_memory_allocated(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
        return {"device": str(self.device), "max_memory_allocated": peak}

    def ping(self) -> int:
        return self.stage


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------

def _channel_capacity(cfg: LlamaConfig, microbatch_size: int, seq_len: int,
                      depth: int) -> int:
    """Bytes of one edge's ring: `depth` records of one microbatch's
    activation in `cfg.dtype`, each with 4096 bytes of pickle slack (a
    pickled CPU tensor and its tag take about 450 beyond its data)."""
    record = (
        microbatch_size * seq_len * cfg.dim * cfg.dtype.itemsize + 4096
    )
    # Bounded depth IS the backpressure: a stage can run at most
    # `depth` records ahead of its consumer before put() blocks.
    return depth * record + 8192


class MPMDPipeline:
    """Driver for MPMD pipeline-parallel training of the flagship
    Llama stack.

    Build once (spawns the stage actors, wires channel edges, installs
    params), then call `step(tokens, targets)` per global batch.
    Geometry: ``global batch = num_microbatches * microbatch_size``,
    layer partition from `partition_layers` (pass `layer_ms` /
    `embed_ms` / `head_ms` measured per layer to balance the asymmetric
    ends; uniform otherwise). `params` is a whole `Llama`'s state dict;
    without it the model is `init_params(cfg, generator)` with the
    generator seeded by `init_key`. The runtime must be up (`init()`),
    with `num_cpus_per_stage * n_stages` CPUs and, on "cuda", its cards.
    `build_ms` holds the times of the build's parts (the stage actors'
    start, the wiring, the parameters' install), in ms.
    """

    def __init__(
        self,
        cfg: LlamaConfig,
        n_stages: int,
        *,
        num_microbatches: int,
        microbatch_size: int,
        seq_len: int,
        chunks_per_stage: int = 1,
        optimizer_factory: Optional[Callable] = None,
        layer_ms: Optional[Sequence[float]] = None,
        embed_ms: float = 0.0,
        head_ms: float = 0.0,
        channel_depth: Optional[int] = None,
        hop_timeout_s: Optional[float] = None,
        step_timeout_s: Optional[float] = None,
        init_key: int = 0,
        params: Optional[Dict[str, torch.Tensor]] = None,
        num_cpus_per_stage: int = 1,
        device: str = "cuda",
    ):
        if n_stages < 2:
            raise ValueError("MPMD pipeline needs >= 2 stages")
        if device not in ("cuda", "cpu"):
            raise ValueError(f"device {device!r}: 'cuda' or 'cpu'")
        config = Config.from_env()
        self.cfg = cfg
        self.device = device
        self.n = int(n_stages)
        self.v = int(chunks_per_stage)
        self.V = self.n * self.v
        self.m = int(num_microbatches)
        self.mb = int(microbatch_size)
        self.seq = int(seq_len)
        self.depth = int(
            channel_depth or config.pipeline_channel_depth
        )
        self.hop_timeout = float(
            hop_timeout_s or config.pipeline_hop_timeout_s
        )
        self.step_timeout = float(
            step_timeout_s or config.pipeline_step_timeout_s
        )
        if isinstance(layer_ms, (int, float)):
            # A measured `layer_ms` is one number for a homogeneous
            # stack — broadcast it.
            layer_ms = [float(layer_ms)] * cfg.n_layers
        self.bounds = partition_layers(
            cfg.n_layers,
            self.V,
            layer_ms,
            embed_ms=embed_ms,
            head_ms=head_ms,
        )
        self.schedules = interleaved_1f1b(self.n, self.m, self.v)
        # Bounded-edge validation: a schedule too deep for the
        # configured channel depth must die HERE (ValueError naming
        # the depth), never as an all-stages hang at hop-timeout.
        validate_schedule(
            self.schedules, self.n, self.m, self.v,
            channel_depth=self.depth,
        )
        self.stash_bound = max(
            max_stash_depth(ops) for ops in self.schedules
        )
        num_gpus = 0.0
        if device == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "MPMDPipeline(device='cuda'): no CUDA device; pass "
                    "device='cpu' to run the stages on the CPU")
            cards = rt.cluster_resources().get("GPU", 0)
            if cards <= 0:
                raise RuntimeError(
                    "MPMDPipeline(device='cuda'): the cluster has no GPU "
                    "resource (init(num_gpus=...))")
            num_gpus = min(1.0, cards / self.n)
        self._broken = False
        self._edges_by_boundary: Dict[
            Tuple[int, str], Edge
        ] = {}
        self.build_ms: Dict[str, float] = {}
        t0 = time.monotonic()
        self._spawn(optimizer_factory, num_cpus_per_stage, num_gpus)
        t1 = time.monotonic()
        self._wire()
        t2 = time.monotonic()
        self._install_params(params, init_key)
        t3 = time.monotonic()
        self.build_ms = {"spawn": (t1 - t0) * 1e3, "wire": (t2 - t1) * 1e3,
                         "params": (t3 - t2) * 1e3}
        self._step_index = 0

    # -- build ---------------------------------------------------------
    def _spawn(self, optimizer_factory, num_cpus: int,
               num_gpus: float) -> None:
        options = {"num_cpus": num_cpus}
        if num_gpus:
            options["num_gpus"] = num_gpus
        stage_cls = rt.remote(**options)(_PipelineStage)
        chunk_of_stage = {
            s: [
                (c, *self.bounds[c])
                for c in range(s, self.V, self.n)
            ]
            for s in range(self.n)
        }
        self.stages = [
            stage_cls.remote(
                s,
                self.n,
                self.cfg,
                chunk_of_stage[s],
                self.V,
                self.m,
                self.schedules[s],
                optimizer_factory,
                self.hop_timeout,
                self.device,
                num_cpus,
            )
            for s in range(self.n)
        ]
        rt.get(
            [a.ping.remote() for a in self.stages], timeout=120
        )

    def _placements(self) -> Dict[int, Optional[str]]:
        """stage index -> node id hex (shared compiled-DAG placement
        wait — a just-created actor may still be leasing)."""
        from ..dag.compiled import wait_actor_placements

        by_id = wait_actor_placements(
            [a for a in self.stages], timeout=60.0
        )
        return {
            s: by_id[a.actor_id.binary()]
            for s, a in enumerate(self.stages)
        }

    def _wire(self) -> None:
        placements = self._placements()
        capacity = _channel_capacity(self.cfg, self.mb, self.seq, self.depth)

        def new_edge(boundary: int, direction: str,
                     src: int, dst: int) -> Edge:
            same = placements.get(src) == placements.get(dst)
            chan = (
                ShmChannel(capacity)
                if same
                else TcpChannel(capacity)
            )
            edge = Edge(
                chan,
                f"s{src}->s{dst}:b{boundary}",
                direction,
            )
            self._edges_by_boundary[(boundary, direction)] = edge
            return edge

        fwd_in: List[Dict[int, Optional[Edge]]] = [
            {} for _ in range(self.n)
        ]
        fwd_out = [dict() for _ in range(self.n)]
        bwd_in = [dict() for _ in range(self.n)]
        bwd_out = [dict() for _ in range(self.n)]
        for c in range(self.V):
            src, dst = c % self.n, (c + 1) % self.n
            if c < self.V - 1:
                f_edge = new_edge(c, "fwd", src, dst)
                fwd_out[src][c] = f_edge
                fwd_in[dst][c + 1] = f_edge
                g_edge = new_edge(c, "grad", dst, src)
                bwd_out[dst][c + 1] = g_edge
                bwd_in[src][c] = g_edge
            # chunk 0 has no fwd_in/bwd_out; last chunk no
            # fwd_out/bwd_in — run_step never touches those keys.
        rt.get(
            [
                a.wire.remote(
                    fwd_in[s], fwd_out[s], bwd_in[s], bwd_out[s]
                )
                for s, a in enumerate(self.stages)
            ],
            timeout=120,
        )

    def _install_params(self, params, init_key) -> None:
        if params is None:
            params = init_params(
                self.cfg, torch.Generator().manual_seed(init_key),
                device="cpu",
            ).state_dict()
        per_stage: List[Dict[int, Dict[str, torch.Tensor]]] = [
            {} for _ in range(self.n)
        ]
        for c, (lo, hi) in enumerate(self.bounds):
            state: Dict[str, torch.Tensor] = {}
            if c == 0:
                state["embed.weight"] = params["embed.weight"]
            for i in range(lo, hi):
                prefix = f"layers.{i}."
                for k, v in params.items():
                    if k.startswith(prefix):
                        state[f"layers.{i - lo}.{k[len(prefix):]}"] = v
            if c == self.V - 1:
                state["final_norm"] = params["final_norm"]
                state["lm_head.weight"] = params["lm_head.weight"]
            per_stage[c % self.n][c] = {
                k: v.detach().cpu() for k, v in state.items()
            }
        rt.get(
            [
                a.set_params.remote(per_stage[s])
                for s, a in enumerate(self.stages)
            ],
            timeout=300,
        )

    # -- stepping ------------------------------------------------------
    def step(self, tokens, targets) -> dict:
        """One global-batch training step. tokens/targets: [B, T]
        integer arrays or tensors with B == num_microbatches *
        microbatch_size (targets < 0 masked). Returns {"loss",
        "stages": [per-stage telemetry]}; raises MPMDPipelineError
        (never hangs) when a stage dies or a channel times out."""
        if self._broken:
            raise MPMDPipelineError(
                "pipeline is broken (a previous step failed)"
            )
        tokens = torch.as_tensor(tokens).cpu().long()
        targets = torch.as_tensor(targets).cpu().long()
        B = tokens.shape[0]
        if B != self.m * self.mb:
            raise ValueError(
                f"batch {B} != num_microbatches {self.m} x "
                f"microbatch_size {self.mb}"
            )
        # Clones, not views: a pickled view carries its whole storage.
        tokens_mbs = [
            tokens[i * self.mb : (i + 1) * self.mb].clone()
            for i in range(self.m)
        ]
        targets_mbs = [
            targets[i * self.mb : (i + 1) * self.mb].clone()
            for i in range(self.m)
        ]
        self._step_index += 1
        refs = []
        for s, actor in enumerate(self.stages):
            refs.append(
                actor.run_step.remote(
                    self._step_index,
                    tokens_mbs if s == 0 else None,
                    targets_mbs if s == self.n - 1 else None,
                )
            )
        results = self._gather(refs)
        last = results[self.n - 1]
        count = max(last["count"], 1.0)
        aux_total = sum(r["aux"] for r in results)
        loss = (
            last["nll"] / count
            + self.cfg.moe_aux_weight * aux_total / self.m
        )
        return {"loss": loss, "stages": results}

    def _gather(self, refs) -> List[dict]:
        """Collect every stage's result; the FIRST failure aborts the
        pipeline: all channel edges close (same-host shm peers
        unblock with ChannelClosedError immediately instead of
        waiting out hop timeouts; cross-host TCP stages that stay
        blocked past the drain deadline are force-killed), then
        raises with the root cause. Bounded by step_timeout + drain
        end to end."""
        deadline = time.monotonic() + self.step_timeout
        results: List[Optional[dict]] = [None] * len(refs)
        pending = dict(enumerate(refs))
        first_err: Optional[BaseException] = None
        while pending and time.monotonic() < deadline:
            for i in list(pending):
                try:
                    results[i] = rt.get(pending[i], timeout=0.25)
                    del pending[i]
                except GetTimeoutError:
                    continue
                except Exception as e:  # noqa: BLE001 — stage death
                    first_err = first_err or e
                    del pending[i]
                    self._abort()
            if first_err:
                # Straight to the bounded drain + force-kill below —
                # polling stuck survivors here would stretch recovery
                # to hop/step timeouts instead of the 15s drain.
                break
        if pending and first_err is None:
            first_err = MPMDPipelineError(
                f"step exceeded step_timeout_s={self.step_timeout:g} "
                f"with {len(pending)} stage(s) outstanding"
            )
            self._abort()
        if first_err is not None:
            # Same-host edges are closed (ShmChannel's shared flag
            # unblocks peers immediately); drain the survivors so no
            # ref leaks.
            drain_deadline = time.monotonic() + 15.0
            stuck: List[int] = []
            for i in list(pending):
                try:
                    rt.get(
                        pending[i],
                        timeout=max(
                            0.1, drain_deadline - time.monotonic()
                        ),
                    )
                except GetTimeoutError:
                    stuck.append(i)
                except Exception:  # noqa: BLE001 — draining
                    pass
            # A stage still blocked past the drain deadline is on a
            # CROSS-HOST edge: the driver's TcpChannel copy owns no
            # socket (roles bind on first use), so edge.close() above
            # couldn't reach it — force-kill the actor; its dying
            # sockets unblock ITS peers in turn.
            for i in stuck:
                try:
                    rt.kill(self.stages[i])
                except Exception:  # noqa: BLE001 — teardown
                    pass
                try:
                    rt.get(pending[i], timeout=10)
                except Exception:  # noqa: BLE001 — draining
                    pass
            raise MPMDPipelineError(
                f"pipeline step failed: {first_err!r}"
            ) from first_err
        return results  # type: ignore[return-value]

    def _abort(self) -> None:
        self._broken = True
        for edge in self._edges_by_boundary.values():
            try:
                edge.close()
            except Exception:  # noqa: BLE001 — teardown
                pass

    # -- checkpoints (async barrier compose) --------------------------
    def save_checkpoint(self, root: str,
                        async_save: bool = True) -> List[str]:
        """Each stage saves its shard (params + optimizer state);
        with async_save the host snapshot happens now and persistence
        overlaps the next steps — `wait_for_checkpoints()` is the
        durability barrier."""
        return rt.get(
            [
                a.save.remote(root, self._step_index, async_save)
                for a in self.stages
            ],
            timeout=300,
        )

    def wait_for_checkpoints(self) -> None:
        rt.get(
            [a.wait_ckpt.remote() for a in self.stages],
            timeout=600,
        )

    def restore_checkpoint(self, root: str, step: int) -> None:
        rt.get(
            [a.restore.remote(root, step) for a in self.stages],
            timeout=300,
        )
        self._step_index = int(step)

    # -- introspection -------------------------------------------------
    def collect_params(self) -> Dict[str, torch.Tensor]:
        """Reassemble the whole model's state dict (a `Llama`'s names,
        CPU tensors) from the stage shards (tests / export)."""
        per_stage = rt.get(
            [a.get_params.remote() for a in self.stages],
            timeout=300,
        )
        by_chunk: Dict[int, Dict[str, torch.Tensor]] = {}
        for shard in per_stage:
            by_chunk.update(shard)
        state: Dict[str, torch.Tensor] = {}
        for c, (lo, _hi) in enumerate(self.bounds):
            for k, v in by_chunk[c].items():
                if k.startswith("layers."):
                    _, j, leaf = k.split(".", 2)
                    k = f"layers.{lo + int(j)}.{leaf}"
                state[k] = v
        return state

    def theoretical_efficiency(self) -> float:
        return theoretical_efficiency(self.n, self.m, self.v)

    def shutdown(self) -> None:
        for edge in self._edges_by_boundary.values():
            try:
                edge.close()
                edge.unlink()
            except Exception:  # noqa: BLE001 — teardown
                pass
        for actor in getattr(self, "stages", []):
            try:
                rt.kill(actor)
            except Exception:  # noqa: BLE001 — teardown
                pass
