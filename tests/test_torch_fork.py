"""Each copy in the port of a JAX-free module of `ray_tpu` is its source
plus the reviewed hunks of `ray_tpu_torch/fork.patch`, and the protocol
and arena sources are byte-identical to theirs (`tests/_torch_fork.py`):
a change to a source that its copy lacks fails here, naming the file.
Reads the sources as text; imports nothing of `ray_tpu`."""

import pytest

from _torch_fork import BYTE_IDENTICAL, PATCH, PORT, ROOT, copies, \
    fork_patch, section

COPIES = copies()
REWRITE = ("port the change, or review the new hunks, then run "
           "`python tests/_torch_fork.py --write`")


def test_the_runtime_copies_are_found():
    # The runtime, its API, dag/, util/, data/, tune/ and the earlier
    # slices' copies.
    assert len(COPIES) >= 50
    for copy in ("ray_tpu_torch/_private/daemon.py",
                 "ray_tpu_torch/_private/worker.py",
                 "ray_tpu_torch/api.py", "ray_tpu_torch/dag/compiled.py",
                 "ray_tpu_torch/train/worker_group.py",
                 "ray_tpu_torch/parallel/schedule.py",
                 "ray_tpu_torch/rl/env.py",
                 "ray_tpu_torch/rl/actor_manager.py",
                 "ray_tpu_torch/rl/rollout_queue.py",
                 "ray_tpu_torch/rl/weight_sync.py",
                 "ray_tpu_torch/train/telemetry.py",
                 "ray_tpu_torch/devtools/lint.py",
                 "ray_tpu_torch/devtools/rules.py",
                 "ray_tpu_torch/devtools/contracts.py",
                 "ray_tpu_torch/devtools/check.py",
                 "ray_tpu_torch/devtools/concurrency.py",
                 "ray_tpu_torch/data/__init__.py",
                 "ray_tpu_torch/data/block.py",
                 "ray_tpu_torch/data/tfrecords.py",
                 "ray_tpu_torch/data/executor.py",
                 "ray_tpu_torch/data/dataset.py",
                 "ray_tpu_torch/data/read_api.py",
                 "ray_tpu_torch/tune/__init__.py",
                 "ray_tpu_torch/tune/search.py",
                 "ray_tpu_torch/tune/schedulers.py",
                 "ray_tpu_torch/tune/session.py",
                 "ray_tpu_torch/tune/tuner.py"):
        assert copy in COPIES


@pytest.mark.parametrize("copy", sorted(COPIES))
def test_copy_is_its_source_plus_the_reviewed_patch(copy):
    source = COPIES[copy]
    assert (ROOT / source).is_file(), f"{copy} names a missing {source}"
    hunks = section(copy, source)
    assert hunks in PATCH.read_text(encoding="utf-8"), (
        f"{copy} differs from {source} outside {PATCH.name}: {REWRITE}")


def test_the_patch_holds_nothing_else():
    """No stale section for a copy that went, or a hunk out of order."""
    assert fork_patch() == PATCH.read_text(encoding="utf-8"), REWRITE


@pytest.mark.parametrize("name", BYTE_IDENTICAL)
def test_byte_identical_copies(name):
    assert (PORT / name).read_bytes() == (ROOT / "ray_tpu" / name).read_bytes()
