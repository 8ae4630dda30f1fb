"""Decoupled RL dataflow: Sebulba-style rollout/learner split (PyTorch
port of `ray_tpu/rl/dataflow.py`).

The synchronous path (`PPO.train`: sample -> update -> broadcast) is
a gather barrier — actors idle while the learner trains and the
learner idles while actors sample. This module splits the loop into
pipelined stages that only meet at explicit, instrumented seams
(PAPERS: "Podracer architectures for scalable Reinforcement
Learning"; "MindSpeed RL: Distributed Dataflow for Scalable and
Efficient RL Training"):

  env-runner actors --(fixed-shape fragments, zero-copy refs)-->
      RolloutQueue (bounded + weight-lag gated, rollout_queue.py)
          --(prefetch pipeline, queue-wait billed like data_wait)-->
              learner (in-driver update on its device)
                  --(drainless versioned push, weight_sync.py)-->
                      engine / weight store / queue version gates

Policy inference during rollout runs in one of two modes:

* ``policy="local"`` — classic Sebulba: each runner holds the policy
  params and samples on the host, refreshing from the WeightStore between
  fragments. Identical per-step work to the synchronous baseline, so
  rlbench's comparison isolates pure dataflow overlap.
* ``policy="engine"`` — the RLHF shape: runners hold NO weights and
  call a continuous-batching `InferenceEngine` (llm/engine.py policy
  path) whose step loop coalesces all runners' ragged per-env
  requests into one batched forward; weight pushes land in the
  engine WITHOUT draining it.

The driver is single-threaded and keeps every runner saturated with a
2-deep call pipeline (a runner finishes fragment N and immediately
starts N+1 from its mailbox; the driver only tops the mailbox up), so
rollout and learning overlap without background threads in the
driver. A dead runner costs its in-flight fragment, never the flow:
the driver respawns the slot, re-syncs weights, and keeps pumping.

Placement: the learner runs in the driver on its own device, and the
policy engine in an actor on the learner's kind of device: on "cuda"
it asks a share of the cards (a learner on the CPU keeps it on the
host). The reference's engine actor asks `num_cpus=0` and nothing
else, so it serves the policy from the host (ROADMAP queue 3,
hazards). The runners sample on the host, as the reference's do. The
policy program's forward is the compile-watch program
`rl.policy_program`, the JAX package's name (one signature per bucket).
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..llm.engine import BatchProgram

__all__ = [
    "PolicyProgram",
    "PolicyEngineActor",
    "RLDataflow",
    "DataflowConfig",
]


# ---------------------------------------------------------------------
# policy batch program (the engine's pluggable non-LLM path)
# ---------------------------------------------------------------------

class PolicyProgram(BatchProgram):
    """BatchProgram serving the rl/models.py MLP policy: one forward
    over a padded observation batch -> sampled actions,
    greedy actions (DQN's argmax head), log-probs and values. Padded
    rows are junk-in/junk-out — the engine slices each ticket's rows
    back out, so padding never leaks (same contract as the LLM
    path's masked dead slots)."""

    def __init__(
        self,
        obs_size: int,
        buckets: Tuple[int, ...] = (8, 16, 32, 64, 128, 256),
    ):
        self.obs_size = int(obs_size)
        self.buckets = tuple(sorted(int(b) for b in buckets))
        from .._private import compile_watch

        self._jit = compile_watch.instrument("rl.policy_program", self._run)

    def run(self, params, inputs, generator) -> Dict[str, Any]:
        """(PolicyNet, obs [bucket, obs_size] on its device, a generator
        on that device) -> actions, greedy, logp, values as tensors."""
        return self._jit(params, inputs, generator)

    @staticmethod
    @torch.no_grad()
    def _run(params, inputs, generator) -> Dict[str, Any]:
        from .models import apply_policy

        logits, values = apply_policy(params, inputs)
        actions = torch.multinomial(
            torch.softmax(logits, -1), 1, generator=generator
        )
        logp = torch.log_softmax(logits, -1).gather(1, actions)[:, 0]
        return {
            "actions": actions[:, 0],
            "greedy": torch.argmax(logits, dim=1),
            "logp": logp,
            "values": values,
        }


class PolicyEngineActor:
    """Actor body hosting a policy-only InferenceEngine. Deploy with
    ``max_concurrency > num_runners`` so concurrent `act` calls park
    on tickets while the engine's step loop batches them — the
    continuous-batching win over per-runner inference. Engine death
    surfaces as `EngineDead` to every pending caller, fast. `params`
    (and every push) is the JAX package's tree of numpy arrays, as the
    learners' `get_weights` returns it; the engine computes on
    `device` ("cuda", the default: the first card the worker sees)."""

    def __init__(
        self,
        params: Dict[str, Any],
        obs_size: int,
        *,
        buckets: Tuple[int, ...] = (8, 16, 32, 64, 128, 256),
        seed: int = 0,
        device: str = "cuda",
    ):
        from ..llm.engine import EngineConfig, InferenceEngine
        from .learner import resolve_device
        from .models import load_jax_policy_params

        self._device = resolve_device(device)
        self._engine = InferenceEngine(
            load_jax_policy_params(params, self._device),
            None,  # policy-only: no KV cache, no slot machinery
            EngineConfig(seed=seed),
            family="rl-policy",
            program=PolicyProgram(obs_size, buckets),
        )

    def act(self, obs) -> Dict[str, Any]:
        ticket = self._engine.submit_policy(np.asarray(obs))
        out = dict(ticket.result(timeout=60.0))
        out["weight_version"] = ticket.version
        return out

    def update_weights(self, params, *, version: int) -> int:
        from .models import load_jax_policy_params

        return self._engine.update_weights(
            load_jax_policy_params(params, self._device), version=version
        )

    def stats(self) -> Dict[str, Any]:
        return self._engine.stats()

    def die(self) -> None:
        """Chaos hook: kill the ENGINE LOOP (not the actor) so tests
        can prove pending policy requests fail fast with EngineDead
        instead of hanging."""
        self._engine.close()

    def ping(self) -> str:
        return "ok"


# ---------------------------------------------------------------------
# env-runner actor
# ---------------------------------------------------------------------

class _DataflowRunner:
    """Actor body: vectorized envs + one fragment per call.

    The driver paces calls (2-deep pipeline); each call samples one
    fixed-shape fragment, `rt.put`s it (zero-copy arena block) and
    offers the WRAPPED ref to the rollout queue, honoring both
    backpressure gates. Episode state (env positions, running
    returns) lives here, so a dropped fragment never corrupts
    episode accounting."""

    def __init__(
        self,
        env_spec,
        num_envs: int,
        rollout_length: int,
        gamma: float,
        gae_lambda: float,
        seed: int,
        runner_id: int,
        queue,
        *,
        engine=None,
        weight_store=None,
        algo: str = "ppo",
    ):
        from .env import VectorEnv, make_env

        self.vec = VectorEnv(
            lambda s: make_env(env_spec, seed=s), num_envs, seed=seed
        )
        self.rollout_length = int(rollout_length)
        self.gamma = gamma
        self.lam = gae_lambda
        self.runner_id = int(runner_id)
        self.algo = algo
        self._queue = queue
        self._engine = engine
        self._store = weight_store
        self._params = None
        self._version = 0
        self._gen = torch.Generator().manual_seed(seed)
        self._obs = self.vec.reset()
        self._ep_returns = np.zeros(num_envs)
        self._finished: List[float] = []
        self._rng = np.random.default_rng(seed ^ 0xC0FFEE)
        # Local inference runs the SAME batch program the engine path
        # serves, on the host (the reference's runners sample on the
        # host CPU too), so the two modes differ only in WHERE the
        # forward runs.
        self._program = PolicyProgram(self._obs.shape[1])

    def ping(self) -> str:
        return "ok"

    def set_weights(self, params, version: int = 0) -> int:
        from .models import load_jax_policy_params

        self._params = load_jax_policy_params(params, "cpu")
        self._version = int(version)
        return self._version

    # -- policy inference ---------------------------------------------
    def _refresh_weights(self) -> None:
        """Local mode: pull newer weights from the store if the
        version moved (one int RPC in the common no-op case)."""
        if self._store is None:
            return
        import ray_tpu_torch as rt

        from .models import load_jax_policy_params

        latest = rt.get(
            self._store.latest_version.remote(), timeout=30
        )
        if latest > self._version:
            version, item = rt.get(
                self._store.get.remote(), timeout=30
            )
            if item is not None:
                self._params = load_jax_policy_params(
                    rt.get(item[0], timeout=30), "cpu"
                )
                self._version = int(version)

    def _act(self, obs: np.ndarray, epsilon: float) -> Dict[str, Any]:
        if self._engine is not None:
            import ray_tpu_torch as rt

            out = rt.get(self._engine.act.remote(obs), timeout=60)
            self._version = int(out.get("weight_version") or 0)
        else:
            from .models import to_f32

            assert self._params is not None, "set_weights first"
            out = {
                k: v.numpy()
                for k, v in self._program.run(
                    self._params, to_f32(obs), self._gen
                ).items()
            }
        if self.algo == "dqn":
            # Epsilon-greedy over the greedy (argmax-Q) head,
            # explored runner-side so the batch program stays
            # stateless and shared across algorithms.
            n = len(obs)
            explore = self._rng.integers(
                0, self._num_actions(), size=n
            )
            coin = self._rng.random(n) < epsilon
            out = dict(out)
            out["actions"] = np.where(
                coin, explore, np.asarray(out["greedy"])
            ).astype(np.int64)
        return out

    def _num_actions(self) -> int:
        return self.vec.envs[0].num_actions

    # -- one fragment --------------------------------------------------
    def sample_and_put(
        self,
        *,
        epsilon: float = 0.0,
        put_retry_s: float = 0.02,
        put_deadline_s: float = 30.0,
    ) -> Dict[str, Any]:
        import ray_tpu_torch as rt

        self._refresh_weights()
        t0 = time.perf_counter()
        T, N = self.rollout_length, self.vec.num_envs
        obs_buf = np.zeros((T, N, self._obs.shape[1]), np.float32)
        act_buf = np.zeros((T, N), np.int32)
        logp_buf = np.zeros((T, N), np.float32)
        val_buf = np.zeros((T, N), np.float32)
        rew_buf = np.zeros((T, N), np.float32)
        done_buf = np.zeros((T, N), np.bool_)
        next_obs_buf = (
            np.zeros((T, N, self._obs.shape[1]), np.float32)
            if self.algo == "dqn" else None
        )
        act_ms = 0.0
        version_floor: Optional[int] = None
        for t in range(T):
            a0 = time.perf_counter()
            out = self._act(self._obs, epsilon)
            act_ms += (time.perf_counter() - a0) * 1e3
            if version_floor is None:
                version_floor = self._version
            version_floor = min(version_floor, self._version)
            actions = np.asarray(out["actions"])
            obs_buf[t] = self._obs
            act_buf[t] = actions
            logp_buf[t] = np.asarray(out["logp"])
            val_buf[t] = np.asarray(out["values"])
            next_obs, rewards, terminated, truncated = self.vec.step(
                actions
            )
            rew_buf[t] = rewards
            done_buf[t] = terminated
            if next_obs_buf is not None:
                next_obs_buf[t] = next_obs
            self._ep_returns += rewards
            for i in range(N):
                if terminated[i] or truncated[i]:
                    self._finished.append(float(self._ep_returns[i]))
                    self._ep_returns[i] = 0.0
            self._obs = next_obs
        if self.algo == "ppo":
            from .env_runner import compute_gae

            last_out = self._act(self._obs, 0.0)
            last_values = np.asarray(last_out["values"])
            adv = compute_gae(
                rew_buf, val_buf, done_buf, last_values,
                self.gamma, self.lam,
            )
            returns = adv + val_buf
            flat = lambda a: a.reshape(-1, *a.shape[2:])  # noqa: E731
            fragment = {
                "obs": flat(obs_buf),
                "actions": flat(act_buf),
                "logp": flat(logp_buf),
                "advantages": flat(adv),
                "value_targets": flat(returns),
            }
        else:
            flat = lambda a: a.reshape(-1, *a.shape[2:])  # noqa: E731
            fragment = {
                "obs": flat(obs_buf),
                "actions": flat(act_buf),
                "rewards": flat(rew_buf),
                "next_obs": flat(next_obs_buf),
                "dones": flat(done_buf).astype(np.float32),
            }
        meta = {
            "runner": self.runner_id,
            "weight_version": int(version_floor or 0),
            "env_steps": T * N,
            "ts": time.time(),
        }
        episode_returns = self._finished
        self._finished = []
        # Offer under both gates: "full" waits (learner behind —
        # capacity backpressure), "throttle" refreshes weights and
        # re-offers under the new version IF the fragment is still
        # inside the lag bound — otherwise it is dropped (stale data
        # must not train).
        ref = rt.put(fragment)
        status = "dropped"
        waits_full = 0
        throttles = 0
        deadline = time.monotonic() + put_deadline_s
        while time.monotonic() < deadline:
            verdict = rt.get(
                self._queue.put.remote({"ref": [ref]}, meta),
                timeout=30,
            )
            if verdict == "ok":
                status = "ok"
                break
            if verdict == "full":
                waits_full += 1
                time.sleep(put_retry_s)
                continue
            # "throttle": this fragment's policy version aged past
            # max_weight_lag while sampling — it must not train.
            # Refresh so the NEXT fragment is fresh, drop this one.
            throttles += 1
            self._refresh_weights()
            status = "dropped_stale"
            break
        return {
            "runner": self.runner_id,
            "status": status,
            "env_steps": T * N,
            "weight_version": int(version_floor or 0),
            "episode_returns": episode_returns,
            "act_ms": round(act_ms, 3),
            "wall_ms": round((time.perf_counter() - t0) * 1e3, 3),
            "waits_full": waits_full,
            "throttles": throttles,
        }


# ---------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------

class DataflowConfig:
    """Knobs of the decoupled dataflow; defaults pull from the
    runtime config (``rl_rollout_queue_capacity``,
    ``rl_max_weight_lag``, ``rl_weight_sync_interval_updates`` —
    documented in _private/config.py, overridable per-run here)."""

    def __init__(
        self,
        *,
        policy: str = "local",
        queue_capacity: Optional[int] = None,
        max_weight_lag: Optional[int] = None,
        sync_interval_updates: Optional[int] = None,
        runner_pipeline_depth: int = 0,
        update_rows: Optional[int] = None,
        engine_buckets: Tuple[int, ...] = (8, 16, 32, 64, 128, 256),
    ):
        from .._private.config import Config

        if policy not in ("local", "engine"):
            raise ValueError(
                f"policy must be 'local' or 'engine', got {policy!r}"
            )
        runtime = Config.from_env()
        self.policy = policy
        self.queue_capacity = int(
            queue_capacity
            if queue_capacity is not None
            else runtime.rl_rollout_queue_capacity
        )
        self.max_weight_lag = int(
            max_weight_lag
            if max_weight_lag is not None
            else runtime.rl_max_weight_lag
        )
        self.sync_interval_updates = int(
            sync_interval_updates
            if sync_interval_updates is not None
            else runtime.rl_weight_sync_interval_updates
        )
        #: Queued sample calls per runner MAILBOX. The driver is
        #: single-threaded: while the learner's update runs, runners
        #: drain their mailboxes back-to-back — the depth must cover
        #: one update's wall or the fleet idles mid-update. 0 = auto:
        #: spread the queue capacity across the fleet (the queue's
        #: own gates remain the real backpressure bound).
        self.runner_pipeline_depth = int(runner_pipeline_depth)
        self.update_rows = update_rows
        self.engine_buckets = tuple(engine_buckets)

    def resolved_pipeline_depth(self, num_runners: int) -> int:
        if self.runner_pipeline_depth > 0:
            return self.runner_pipeline_depth
        per_runner = (
            self.queue_capacity + num_runners - 1
        ) // max(1, num_runners)
        return max(2, min(16, per_runner))


class RLDataflow:
    """The composed dataflow driver: owns the queue, the weight path,
    the runner fleet (and, in engine mode, the policy engine actor),
    and drives the learner against the queue through a device
    prefetch pipeline. `learner` is any object with
    ``update(batch) -> metrics`` / ``get_weights()`` (TorchLearner, a
    LearnerGroup, or the DQNLearner adapter)."""

    def __init__(
        self,
        learner,
        *,
        env_spec,
        obs_size: int,
        num_env_runners: int = 2,
        num_envs_per_runner: int = 8,
        rollout_length: int = 64,
        gamma: float = 0.99,
        gae_lambda: float = 0.95,
        seed: int = 0,
        algo: str = "ppo",
        flow: Optional[DataflowConfig] = None,
        epsilon_fn: Optional[Callable[[int], float]] = None,
    ):
        import ray_tpu_torch as rt

        self._rt = rt
        self.learner = learner
        self.flow = flow or DataflowConfig()
        self.algo = algo
        self._epsilon_fn = epsilon_fn or (lambda env_steps: 0.0)
        self._env_spec = env_spec
        self._seed = seed
        self._version = 0
        self._updates = 0
        self._env_steps = 0
        self._fragments_ok = 0
        self._fragments_dropped = 0
        self._frags_by_runner: Dict[int, int] = {}
        self._runner_failures = 0
        self._waits_full = 0
        self._throttles = 0
        self._last_sync_ms = 0.0
        self._recent_returns: List[float] = []
        self._stopped = False
        cfg = self.flow
        self._update_rows = cfg.update_rows or (
            num_env_runners * num_envs_per_runner * rollout_length
        )

        from .rollout_queue import RolloutQueue
        from .weight_sync import WeightStore

        queue_cls = rt.remote(num_cpus=0)(RolloutQueue)
        self._queue = queue_cls.remote(
            cfg.queue_capacity, cfg.max_weight_lag
        )
        self._store = None
        self._engine = None
        params0 = learner.get_weights()
        if cfg.policy == "engine":
            options = {
                "num_cpus": 0,
                "max_concurrency": max(4, num_env_runners + 2),
            }
            # The engine computes on the learner's kind of device (a
            # learner without one, a LearnerGroup, on the card).
            engine_device = getattr(
                getattr(learner, "device", None), "type", "cuda"
            )
            if engine_device == "cuda":
                cards = rt.cluster_resources().get("GPU", 0)
                if cards <= 0:
                    raise RuntimeError(
                        "policy engine on 'cuda': the cluster has no GPU "
                        "resource (init(num_gpus=...)); pass "
                        "a learner on device='cpu' to serve from the host"
                    )
                options["num_gpus"] = min(1.0, cards)
            engine_cls = rt.remote(**options)(PolicyEngineActor)
            self._engine = engine_cls.remote(
                params0,
                obs_size,
                buckets=cfg.engine_buckets,
                seed=seed,
                device=engine_device,
            )
            # A GPU worker starts a fresh interpreter (about 9 s).
            rt.get(self._engine.ping.remote(), timeout=120)
        else:
            store_cls = rt.remote(num_cpus=0)(WeightStore)
            self._store = store_cls.remote()

        runner_cls = rt.remote(num_cpus=1)(_DataflowRunner)

        def make_runner(idx: int):
            return runner_cls.remote(
                env_spec,
                num_envs_per_runner,
                rollout_length,
                gamma,
                gae_lambda,
                seed + 1000 * idx,
                idx,
                self._queue,
                engine=self._engine,
                weight_store=self._store,
                algo=algo,
            )

        self._make_runner = make_runner
        self._pipeline_depth = cfg.resolved_pipeline_depth(
            num_env_runners
        )
        self._runners: Dict[int, dict] = {}
        for idx in range(num_env_runners):
            handle = make_runner(idx)
            self._runners[idx] = {"handle": handle, "refs": deque()}
        if cfg.policy == "local":
            weights_ref = rt.put(params0)
            rt.get(
                [
                    st["handle"].set_weights.remote(weights_ref, 0)
                    for st in self._runners.values()
                ],
                timeout=120,
            )
        self._batches = self._device_prefetch(
            self._host_batches(), buffer_size=2
        )

    # -- runner pump ---------------------------------------------------
    def _submit(self, idx: int) -> None:
        state = self._runners[idx]
        state["refs"].append(
            state["handle"].sample_and_put.remote(
                epsilon=float(self._epsilon_fn(self._env_steps)),
            )
        )

    def _pump(self) -> None:
        """Top up every runner's call pipeline and fold finished
        fragments' counters in; a failed call (dead runner) drops its
        fragment, respawns the slot and re-syncs weights — the flow
        never stops for one actor."""
        rt = self._rt
        if self._stopped:
            return
        for idx, state in list(self._runners.items()):
            while len(state["refs"]) < self._pipeline_depth:
                self._submit(idx)
        heads = {
            state["refs"][0]: idx
            for idx, state in self._runners.items()
            if state["refs"]
        }
        if not heads:
            return
        ready, _ = rt.wait(
            list(heads), num_returns=len(heads), timeout=0.005
        )
        for ref in ready:
            idx = heads[ref]
            state = self._runners[idx]
            state["refs"].popleft()
            try:
                result = rt.get(ref, timeout=5)
            except Exception:
                # A dead POLICY ENGINE fails every runner the same
                # way; restoring runners against it would spin
                # forever — surface EngineDead to the caller fast
                # instead (never hang the learner loop).
                self._check_engine()
                self._restore_runner(idx)
                continue
            self._env_steps += int(result["env_steps"])
            self._waits_full += int(result.get("waits_full", 0))
            self._throttles += int(result.get("throttles", 0))
            if result["status"] == "ok":
                self._fragments_ok += 1
                self._frags_by_runner[idx] = (
                    self._frags_by_runner.get(idx, 0) + 1
                )
            else:
                self._fragments_dropped += 1
            self._recent_returns.extend(
                result.get("episode_returns") or []
            )
            self._recent_returns = self._recent_returns[-100:]
        self._observe_counters()

    def _check_engine(self) -> None:
        if self._engine is None:
            return
        from ..llm.engine import EngineDead

        try:
            stats = self._rt.get(
                self._engine.stats.remote(), timeout=10
            )
        except Exception as e:
            raise EngineDead(
                "policy engine actor is unreachable"
            ) from e
        if stats.get("dead"):
            raise EngineDead(
                "policy engine step loop died; rollout inference is "
                "down"
            )

    def _restore_runner(self, idx: int) -> None:
        """Prune-and-restore one dead slot: its in-flight fragments
        are lost (dropped, counted), the respawn re-syncs weights at
        the CURRENT version, and pumping resumes next pass."""
        rt = self._rt
        self._runner_failures += 1
        state = self._runners[idx]
        self._fragments_dropped += len(state["refs"]) + 1
        state["refs"].clear()
        try:
            rt.kill(state["handle"])
        except Exception:
            pass
        state["handle"] = self._make_runner(idx)
        if self.flow.policy == "local":
            try:
                ref = rt.put(self.learner.get_weights())
                rt.get(
                    state["handle"].set_weights.remote(
                        ref, self._version
                    ),
                    timeout=120,
                )
            except Exception:
                pass  # next restore attempt will retry

    # -- learner feed --------------------------------------------------
    def _host_batches(self):
        """Infinite generator of host training batches assembled from
        queue fragments. The stall waiting for runner data is billed
        to ``queue_wait_ms`` — the dataflow's analog of data_wait, so
        doctor/goodput attribute a learner starving on rollouts
        exactly like a trainer starving on input."""
        rt = self._rt
        from .._private import step_telemetry

        frag_rows = 0  # observed fragment size (rows)
        while True:
            frags: List[dict] = []
            rows = 0
            lag_floor: Optional[int] = None
            while rows < self._update_rows:
                self._pump()
                # Ask for just enough fragments to finish this batch:
                # overshooting (grab-everything) would grow the
                # training batch beyond update_rows and break the
                # updates-per-env-step parity with the synchronous
                # baseline the comparison rests on.
                want = (
                    max(
                        1,
                        -(-(self._update_rows - rows) // frag_rows),
                    )
                    if frag_rows else 2
                )
                with step_telemetry.phase_timer("queue_wait_ms"):
                    got = rt.get(
                        self._queue.get_batch.remote(want),
                        timeout=30,
                    )
                    if not got:
                        time.sleep(0.004)
                        continue
                    for frag in got:
                        payload = rt.get(
                            frag["item"]["ref"][0], timeout=30
                        )
                        frags.append(payload)
                        version = int(
                            frag["meta"].get("weight_version", 0)
                        )
                        lag_floor = (
                            version if lag_floor is None
                            else min(lag_floor, version)
                        )
                        n = len(payload[next(iter(payload))])
                        rows += n
                        frag_rows = max(frag_rows, n)
            batch = {
                k: np.concatenate([f[k] for f in frags])
                for k in frags[0]
            }
            lag = self._version - (
                lag_floor if lag_floor is not None else self._version
            )
            from .weight_sync import observe_weight_lag

            observe_weight_lag(lag, role="learner")
            batch["_weight_lag"] = lag
            yield batch

    def _device_prefetch(self, batches, buffer_size: int = 2):
        """The PR 4 prefetch pattern over queue batches: batch N+1's
        copy to the learner's device dispatches before batch N trains
        (h2d billed per update), with the pull stall carried by
        `_host_batches`'s queue_wait timer instead of data_wait — same
        pipeline, the queue is the dataset."""
        from .._private import step_telemetry

        window: deque = deque()
        iterator = iter(batches)
        # A host-ingesting learner (DQNLearner: the batch lands in a
        # host-side replay ring, minibatches upload separately) must
        # not pay an H2D+D2H round trip per batch — nor bill phantom
        # h2d_ms the doctor would misattribute.
        host_ingest = bool(getattr(self.learner, "host_ingest", False))
        # A learner without a device (a LearnerGroup: its actors take
        # host shards through the object store) gets the host batch.
        device = getattr(self.learner, "device", None)

        def put(batch):
            if host_ingest or device is None:
                return batch
            t0 = time.monotonic()
            lag = batch.pop("_weight_lag", 0)
            out = {
                k: torch.from_numpy(v).to(device, non_blocking=True)
                for k, v in batch.items()
            }
            out["_weight_lag"] = lag
            step_telemetry.add_phase(
                "h2d_ms", (time.monotonic() - t0) * 1e3
            )
            return out

        while True:
            while len(window) < buffer_size:
                window.append(put(next(iterator)))
            yield window.popleft()

    # -- one learner update --------------------------------------------
    def train_update(self) -> Dict[str, Any]:
        """Consume one update's worth of fragments and take one
        learner update; publish weights per the sync interval. Emits
        a per-update step-telemetry record (queue_wait / h2d /
        weight_sync as stall phases, the update as step_ms)."""
        from .._private import step_telemetry
        from .weight_sync import push_weights

        t0 = time.monotonic()
        batch = next(self._batches)
        lag = int(batch.pop("_weight_lag", 0))
        # Top the runner mailboxes up RIGHT before the long update:
        # the fleet drains them back-to-back while the driver is
        # inside the update — that is the overlap.
        self._pump()
        u0 = time.monotonic()
        metrics = self.learner.update(batch)
        update_ms = (time.monotonic() - u0) * 1e3
        self._pump()
        self._updates += 1
        self._version += 1
        if (
            self._updates % max(1, self.flow.sync_interval_updates)
            == 0
        ):
            with step_telemetry.phase_timer("weight_sync_ms"):
                self._last_sync_ms = push_weights(
                    self.learner.get_weights(),
                    self._version,
                    engines=(
                        [self._engine]
                        if self._engine is not None else []
                    ),
                    store=self._store,
                    queue=self._queue,
                )
        # Between publishes the queue's learner version deliberately
        # does NOT advance: the staleness gates compare against the
        # last PUBLISHED version — the freshest weights any runner
        # can possibly fetch. Advancing it per update would, at
        # sync_interval_updates > max_weight_lag + 1, throttle every
        # put against weights that do not exist yet and deadlock the
        # flow.
        self._observe_update()
        wall_ms = (time.monotonic() - t0) * 1e3
        step_telemetry.report_step(
            self._updates,
            rank=0,
            step_ms=update_ms,
            wall_ms=wall_ms,
            extra={"weight_version": self._version},
        )
        out = dict(metrics)
        out.update(
            weight_version=self._version,
            weight_lag=lag,
            weight_sync_ms=round(self._last_sync_ms, 3),
            update_ms=round(update_ms, 3),
        )
        return out

    # -- stats / lifecycle ---------------------------------------------
    def queue_stats(self) -> Dict[str, Any]:
        return self._rt.get(
            self._queue.stats.remote(), timeout=30
        )

    def engine_stats(self) -> Optional[Dict[str, Any]]:
        if self._engine is None:
            return None
        return self._rt.get(
            self._engine.stats.remote(), timeout=30
        )

    def stats(self) -> Dict[str, Any]:
        return {
            "env_steps": self._env_steps,
            "updates": self._updates,
            "weight_version": self._version,
            "fragments_ok": self._fragments_ok,
            "fragments_by_runner": dict(self._frags_by_runner),
            "fragments_dropped": self._fragments_dropped,
            "runner_failures": self._runner_failures,
            "waits_full": self._waits_full,
            "throttles": self._throttles,
            "last_weight_sync_ms": round(self._last_sync_ms, 3),
            "episode_return_mean": (
                float(np.mean(self._recent_returns))
                if self._recent_returns else float("nan")
            ),
        }

    def num_healthy_runners(self) -> int:
        rt = self._rt
        healthy = 0
        for state in self._runners.values():
            try:
                rt.get(state["handle"].ping.remote(), timeout=10)
                healthy += 1
            except Exception:
                pass
        return healthy

    def runner_handle(self, idx: int):
        return self._runners[idx]["handle"]

    def shutdown(self) -> None:
        self._stopped = True
        rt = self._rt
        for state in self._runners.values():
            try:
                rt.kill(state["handle"])
            except Exception:
                pass
        for handle in (self._engine, self._store, self._queue):
            if handle is not None:
                try:
                    rt.kill(handle)
                except Exception:
                    pass

    # -- metrics -------------------------------------------------------
    def _observe_counters(self) -> None:
        try:
            from ..util.metrics import Counter, Gauge

            global _ENV_STEPS, _STEPS_GAUGE
            if _ENV_STEPS is None:
                _ENV_STEPS = Counter(
                    "rl_env_steps_total",
                    description=(
                        "Environment steps sampled by the dataflow's "
                        "runner fleet"
                    ),
                    tag_keys=(),
                )
                _STEPS_GAUGE = Gauge(
                    "rl_env_steps",
                    description=(
                        "Environment steps sampled (driver view)"
                    ),
                    tag_keys=(),
                )
            delta = self._env_steps - getattr(
                self, "_env_steps_pushed", 0
            )
            if delta > 0:
                _ENV_STEPS.inc(float(delta))
                self._env_steps_pushed = self._env_steps
                _STEPS_GAUGE.set(float(self._env_steps))
        except Exception:
            pass

    def _observe_update(self) -> None:
        try:
            from ..util.metrics import Counter, Gauge

            global _UPDATES, _VERSION_GAUGE
            if _UPDATES is None:
                _UPDATES = Counter(
                    "rl_learner_updates_total",
                    description=(
                        "Learner updates taken by the dataflow"
                    ),
                    tag_keys=(),
                )
                _VERSION_GAUGE = Gauge(
                    "rl_weight_version",
                    description=(
                        "Latest policy-weight version published by "
                        "the learner"
                    ),
                    tag_keys=("store",),
                )
            _UPDATES.inc(1.0)
            _VERSION_GAUGE.set(
                float(self._version), tags={"store": "learner"}
            )
        except Exception:
            pass


_ENV_STEPS = None
_STEPS_GAUGE = None
_UPDATES = None
_VERSION_GAUGE = None
