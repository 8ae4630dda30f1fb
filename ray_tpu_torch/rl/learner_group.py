"""LearnerGroup: data-parallel learner sharding across actors (PyTorch
port of `ray_tpu/rl/learner_group.py`).

Reference: rllib/core/learner/learner_group.py:81,206 — N learner
actors each take 1/N of the sample batch, compute gradients in
lockstep, and apply the ALL-REDUCED average so every learner's params
stay bit-identical (torch DDP in the reference). TPU-native split:

- On one HOST with a device mesh, multi-chip data parallelism needs no
  actors at all — the single JaxLearner's jitted update shards the
  minibatch over the mesh and XLA psums the gradients in-compile
  (learner.py docstring). That path stays the default.
- ACROSS hosts (or in tests standing in for hosts), this LearnerGroup
  runs one learner actor per shard with the reference's DDP protocol:
  per-minibatch gradient exchange through the object store, averaged
  once, applied everywhere. The effective minibatch size equals the
  single-learner configuration (each learner steps minibatch/N rows),
  so the 2-learner optimization trajectory matches the 1-learner one
  statistically — same effective batch, same step count.

Placement: on "cuda" (the default) each learner actor asks a share of
the node's cards, ``num_gpus = min(1, cards / num_learners)`` (two
learners share one card at 0.5), and binds card ``rank % (cards it
sees)``; `device="cpu"` keeps the reference's CPU-only actors (it asks
only `num_cpus`, so its learners run on the host: ROADMAP queue 3,
hazards). Gradients and weights cross the object store as CPU tensors
and numpy trees, so the driver needs no card.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

_BATCH_KEYS = (
    "obs",
    "actions",
    "logp",
    "advantages",
    "value_targets",
)


class _LearnerActor:
    """Actor body: one TorchLearner + its resident batch shard."""

    def __init__(self, learner_kwargs: dict, rank: int):
        import torch

        from .learner import TorchLearner

        learner_kwargs = dict(learner_kwargs)
        if torch.device(learner_kwargs.get("device", "cuda")).type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    f"learner {rank} was asked for the card and sees no "
                    "CUDA device")
            # A GPU worker sees every card of its node: bind our own.
            learner_kwargs["device"] = torch.device(
                "cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(learner_kwargs["device"])
        self.learner = TorchLearner(**learner_kwargs)
        self.rank = rank
        self._shard = None
        self._order = None

    def ping(self) -> str:
        return "ok"

    def set_batch(self, shard: Dict[str, np.ndarray]) -> int:
        self._shard = self.learner.to_device(shard)
        return len(shard["obs"])

    def start_epoch(self, epoch: int) -> bool:
        """Shuffle this shard for the coming epoch. Seeded by
        (rank, epoch) so ranks draw independent permutations but runs
        are reproducible."""
        n = len(self._shard["obs"])
        rng = np.random.default_rng(
            (self.rank + 1) * 100_003 + epoch
        )
        self._order = rng.permutation(n)
        return True

    def grad_step(
        self, step: int, per_learner_mb: int
    ) -> Tuple[Dict, Dict]:
        import torch

        idx = torch.from_numpy(self._order[
            step * per_learner_mb : (step + 1) * per_learner_mb
        ]).to(self.learner.device)
        minibatch = {k: v[idx] for k, v in self._shard.items()}
        grads, metrics = self.learner.compute_gradients(minibatch)
        return {k: g.cpu() for k, g in grads.items()}, {
            k: float(v) for k, v in metrics.items()
        }

    def apply_grads(self, avg_grads) -> bool:
        self.learner.apply_gradients(avg_grads)
        return True

    def get_weights(self):
        return self.learner.get_weights()

    def set_weights(self, params) -> bool:
        self.learner.set_weights(params)
        return True


def _tree_mean(trees: List[Dict]):
    """Leafwise mean of gradient dicts (tensors by parameter name),
    summed in rank order as the reference's tree_map does."""
    return {
        name: sum(tree[name] for tree in trees) / len(trees)
        for name in trees[0]
    }


class LearnerGroup:
    """Drop-in for TorchLearner's update/get_weights/set_weights surface,
    fanning the update across `num_learners` actors."""

    def __init__(
        self,
        num_learners: int,
        *,
        minibatch_size: int = 256,
        num_epochs: int = 4,
        num_cpus_per_learner: float = 1.0,
        device: str = "cuda",
        **learner_kwargs,
    ):
        import ray_tpu_torch as rt

        assert num_learners >= 1
        if device not in ("cuda", "cpu"):
            raise ValueError(f"device {device!r}: 'cuda' or 'cpu'")
        if minibatch_size % num_learners:
            raise ValueError(
                f"minibatch_size {minibatch_size} must divide evenly "
                f"across {num_learners} learners"
            )
        self._rt = rt
        self.num_learners = num_learners
        self.minibatch_size = minibatch_size
        self.num_epochs = num_epochs
        learner_kwargs = dict(
            learner_kwargs,
            minibatch_size=minibatch_size,
            num_epochs=num_epochs,
            device=device,
        )
        options = {"num_cpus": num_cpus_per_learner}
        if device == "cuda":
            cards = rt.cluster_resources().get("GPU", 0)
            if cards <= 0:
                raise RuntimeError(
                    "LearnerGroup(device='cuda'): the cluster has no GPU "
                    "resource (init(num_gpus=...)); pass device='cpu' to "
                    "learn on the CPU")
            options["num_gpus"] = min(1.0, cards / num_learners)
        actor_cls = rt.remote(**options)(_LearnerActor)
        self.learners = [
            actor_cls.remote(learner_kwargs, rank)
            for rank in range(num_learners)
        ]
        # Rank 0's init is canonical; everyone starts from it
        # (reference: LearnerGroup broadcasts a single init state).
        weights = rt.get(
            self.learners[0].get_weights.remote(), timeout=120
        )
        ref = rt.put(weights)
        rt.get(
            [
                learner.set_weights.remote(ref)
                for learner in self.learners[1:]
            ],
            timeout=120,
        )

    def update(self, batch: Dict[str, np.ndarray]) -> Dict[str, float]:
        """One PPO update pass, DDP-style (reference:
        learner_group.py:206 update_from_batch): split the batch into
        per-learner shards, then per minibatch step all learners
        gradient in lockstep and apply the same average."""
        rt = self._rt
        n = len(batch["obs"])
        world = self.num_learners
        shard_n = n // world
        shard_refs = []
        for rank in range(world):
            lo, hi = rank * shard_n, (rank + 1) * shard_n
            shard_refs.append(
                rt.put(
                    {
                        k: batch[k][lo:hi]
                        for k in _BATCH_KEYS
                        if k in batch
                    }
                )
            )
        rt.get(
            [
                learner.set_batch.remote(ref)
                for learner, ref in zip(self.learners, shard_refs)
            ],
            timeout=300,
        )
        # A batch smaller than one full minibatch must still train
        # (the single-learner path runs its start==0 ragged minibatch;
        # steps==0 here would silently skip the update forever).
        per_learner_mb = max(
            1, min(self.minibatch_size // world, shard_n)
        )
        steps = max(1, shard_n // per_learner_mb)
        metrics: Dict[str, float] = {}
        for epoch in range(self.num_epochs):
            rt.get(
                [
                    learner.start_epoch.remote(epoch)
                    for learner in self.learners
                ],
                timeout=300,
            )
            for step in range(steps):
                outs = rt.get(
                    [
                        learner.grad_step.remote(step, per_learner_mb)
                        for learner in self.learners
                    ],
                    timeout=300,
                )
                grads = _tree_mean([g for g, _ in outs])
                metric_dicts = [m for _, m in outs]
                metrics = {
                    k: float(
                        np.mean([m[k] for m in metric_dicts])
                    )
                    for k in metric_dicts[0]
                }
                grads_ref = rt.put(grads)
                rt.get(
                    [
                        learner.apply_grads.remote(grads_ref)
                        for learner in self.learners
                    ],
                    timeout=300,
                )
        return metrics

    def get_weights(self):
        return self._rt.get(
            self.learners[0].get_weights.remote(), timeout=120
        )

    def set_weights(self, params) -> None:
        ref = self._rt.put(params)
        self._rt.get(
            [
                learner.set_weights.remote(ref)
                for learner in self.learners
            ],
            timeout=120,
        )

    def shutdown(self) -> None:
        for learner in self.learners:
            try:
                self._rt.kill(learner)
            except Exception:
                pass
