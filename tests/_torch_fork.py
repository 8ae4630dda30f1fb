"""The port's copies of JAX-free modules, held to their sources.

A file of `ray_tpu_torch/` whose header says "Copied from ray_tpu/<path>"
(or "Copied verbatim from") is its source plus a reviewed patch: with
every module name of the source rewritten (`ray_tpu` -> `ray_tpu_torch`),
the two differ only by the hunks of `ray_tpu_torch/fork.patch`. A few
files are byte-identical to theirs (`BYTE_IDENTICAL`). Read as text:
nothing of `ray_tpu` is imported.

After changing a copy on purpose, or porting a change of its source,
rewrite the patch and review its diff:

    python tests/_torch_fork.py --write
"""

import difflib
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "ray_tpu_torch"
PATCH = PORT / "fork.patch"
#: Copies kept byte for byte: the protocol (both packages register one
#: `protocol.proto` in protobuf's default pool) and the arena's source.
BYTE_IDENTICAL = ("_private/protocol.proto", "_private/protocol_pb2.py",
                  "_native/store.cc")

_HEADER = re.compile(r"Copied (?:verbatim )?from (ray_tpu/[\w/]+\.\w+)")
_MODULE = re.compile(r"\bray_tpu\b(?!_torch)")


def copies():
    """{copy's path under the repo: source's path}, in path order."""
    found = {}
    for path in sorted(PORT.rglob("*")):
        if path.suffix not in (".py", ".cc") or not path.is_file():
            continue
        with open(path, encoding="utf-8") as f:
            head = "".join(f.readline() for _ in range(3))
        match = _HEADER.search(head)
        if match:
            found[path.relative_to(ROOT).as_posix()] = match.group(1)
    return found


def section(copy, source):
    """The unified diff from `source`, its module names rewritten, to
    `copy` (both paths under the repo)."""
    old = _MODULE.sub("ray_tpu_torch", (ROOT / source).read_text(
        encoding="utf-8"))
    new = (ROOT / copy).read_text(encoding="utf-8")
    return "".join(difflib.unified_diff(
        old.splitlines(keepends=True), new.splitlines(keepends=True),
        fromfile=source, tofile=copy))


def fork_patch():
    return "".join(section(copy, source)
                   for copy, source in copies().items())


if __name__ == "__main__":
    if sys.argv[1:] != ["--write"]:
        sys.exit("usage: python tests/_torch_fork.py --write")
    PATCH.write_text(fork_patch(), encoding="utf-8")
    print(f"wrote {PATCH.relative_to(ROOT)}")
