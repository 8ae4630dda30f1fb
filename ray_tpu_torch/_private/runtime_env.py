# Copied from ray_tpu/_private/runtime_env.py (JAX-free): module names read ray_tpu_torch,
# and the cache lies under the process's temporary directory, apart from
# the reference runtime's.
"""Runtime environments: per-task/actor execution context.

Reference: python/ray/_private/runtime_env/ — env_vars, working_dir,
py_modules (plugin.py's RuntimeEnvPlugin registry; working_dir.py
packages the directory and workers download+cache it by content hash).
Here packaging rides the cluster KV store (the reference uses GCS
packages the same way): the driver zips working_dir/py_modules into
KV under a content hash, workers extract once into a node-local cache
and prepend to sys.path. env_vars apply around task execution and are
restored afterwards (shared workers); actors keep their env for life
(they pin their worker).

`pip` creates a node-local virtualenv per requirements hash (reference:
runtime_env/pip.py builds a virtualenv + pip-installs into it, cached
by a hash of the spec) and prepends its site-packages around task
execution; restore also evicts the env's modules from sys.modules so
shared workers stay clean. The hermetic deployment has no package
index, so requirements must resolve offline (local wheels/dirs) —
network installs surface as RuntimeEnvSetupError exactly like a failed
pip would.

`uv` and `conda` ship as RuntimeEnvPlugin implementations (reference:
runtime_env/uv.py, conda.py) gated on their binaries being on PATH —
validated driver-side for fail-fast on images that don't carry them.
Third-party extensions subclass RuntimeEnvPlugin and register_plugin().
"""

from __future__ import annotations

import hashlib
import io
import os
import pickle
import shutil
import sys
import tempfile
import zipfile
from contextlib import contextmanager
from typing import Any, Dict, Optional

from .. import exceptions as exc

_MAX_PACKAGE_BYTES = 256 * 1024 * 1024
_CACHE_ROOT = os.path.join(tempfile.gettempdir(), "rt_torch_runtime_env_cache")

_KNOWN_FIELDS = {
    "env_vars",
    "working_dir",
    "py_modules",
    "pip",
}


class RuntimeEnvContext:
    """Mutation surface handed to plugins worker-side. Changes made
    through it are recorded into apply_runtime_env's save/restore
    state, so a shared task worker returns to a clean slate; direct
    os.environ/sys.path writes from a plugin would leak."""

    def __init__(self, worker, saved_env: Dict[str, Any]):
        self.worker = worker
        self._saved_env = saved_env

    def set_env(self, key: str, value: str) -> None:
        self._saved_env.setdefault(key, os.environ.get(key))
        os.environ[key] = str(value)

    def prepend_sys_path(self, path: str) -> None:
        # apply_runtime_env snapshots the whole sys.path; prepends are
        # rolled back wholesale.
        sys.path.insert(0, path)
        self.set_env(
            "PYTHONPATH",
            os.pathsep.join(
                p for p in (path, os.environ.get("PYTHONPATH")) if p
            ),
        )


class RuntimeEnvPlugin:
    """Extension point (reference: runtime_env/plugin.py
    RuntimeEnvPlugin — name, priority, create/modify_context hooks).

    A plugin owns one runtime_env key. Lifecycle:
      * validate(value, worker) — DRIVER-side at submit: check the
        value, package/upload anything local, return the wire form.
      * create(wire_value, worker) — WORKER-side, once per distinct
        wire value per process (memoized on the pickled value):
        expensive materialization (build an env, download) happens
        here; the return value is the plugin's state.
      * modify_context(state, wire_value, ctx) — WORKER-side on every
        task apply: activate the state via the RuntimeEnvContext
        (env vars, sys.path); keep it cheap.
    Plugins run in ascending `priority` (built-in fields first)."""

    name: str = ""
    priority: int = 10

    def validate(self, value, worker):
        return value

    def create(self, value, worker):
        return None

    def modify_context(self, state, value, ctx: RuntimeEnvContext):
        pass


_PLUGINS: Dict[str, RuntimeEnvPlugin] = {}
#: (plugin name, pickled wire value) -> created state, per process.
_plugin_state: Dict[tuple, Any] = {}


def register_plugin(plugin: RuntimeEnvPlugin) -> None:
    if not plugin.name or plugin.name in _KNOWN_FIELDS:
        raise ValueError(
            f"plugin name {plugin.name!r} is empty or shadows a "
            f"built-in runtime_env field"
        )
    _PLUGINS[plugin.name] = plugin


def unregister_plugin(name: str) -> None:
    _PLUGINS.pop(name, None)


_external_loaded = False
_external_error: Optional[BaseException] = None


def _load_external_plugins() -> None:
    """Load plugins named by RT_RUNTIME_ENV_PLUGINS (comma-separated
    `module.path:ClassName` or `/abs/file.py:ClassName`) — reference:
    RAY_RUNTIME_ENV_PLUGINS. Driver and workers are separate
    processes; the env var (inherited through the daemon's worker
    env) is what makes a registration visible on both sides.

    A load failure is latched and re-raised on EVERY later call: a
    typo'd entry must keep failing tasks loudly, not fail once and
    then let everything run without the plugin's environment."""
    global _external_loaded, _external_error
    if _external_loaded:
        if _external_error is not None:
            raise exc.RuntimeEnvSetupError(
                f"RT_RUNTIME_ENV_PLUGINS failed to load: "
                f"{_external_error}"
            ) from _external_error
        return
    spec = os.environ.get("RT_RUNTIME_ENV_PLUGINS", "")
    try:
        for item in filter(None, (s.strip() for s in spec.split(","))):
            path, _, clsname = item.partition(":")
            if not clsname:
                raise exc.RuntimeEnvSetupError(
                    f"RT_RUNTIME_ENV_PLUGINS entry {item!r} must be "
                    "module:ClassName or /file.py:ClassName"
                )
            import importlib
            import importlib.util

            if path.endswith(".py"):
                modname = "_rt_env_plugin_" + hashlib.sha256(
                    path.encode()
                ).hexdigest()[:8]
                loaded = importlib.util.spec_from_file_location(
                    modname, path
                )
                mod = importlib.util.module_from_spec(loaded)
                sys.modules[modname] = mod
                loaded.loader.exec_module(mod)
            else:
                mod = importlib.import_module(path)
            register_plugin(getattr(mod, clsname)())
    except BaseException as e:
        _external_error = e
        _external_loaded = True
        raise
    _external_loaded = True


def _zip_dir(path: str, prefix: str = "") -> bytes:
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as zf:
        for root, _, files in os.walk(path):
            for name in files:
                full = os.path.join(root, name)
                rel = os.path.relpath(full, path)
                if rel.startswith(".git" + os.sep):
                    continue
                zf.write(
                    full, os.path.join(prefix, rel) if prefix else rel
                )
    data = buf.getvalue()
    if len(data) > _MAX_PACKAGE_BYTES:
        raise exc.RuntimeEnvSetupError(
            f"packaged dir {path!r} is {len(data)} bytes "
            f"(limit {_MAX_PACKAGE_BYTES})"
        )
    return data


def prepare_runtime_env(
    env: Optional[dict], worker
) -> Optional[dict]:
    """Driver-side: validate + package + upload; returns the wire form
    embedded in the task spec."""
    if not env:
        return None
    _load_external_plugins()
    unknown = set(env) - _KNOWN_FIELDS - set(_PLUGINS)
    if unknown:
        raise ValueError(f"unknown runtime_env fields: {sorted(unknown)}")
    wire: Dict[str, Any] = {}
    if env.get("pip"):
        wire["pip"] = _normalize_pip(env["pip"], worker)
    if env.get("env_vars"):
        wire["env_vars"] = {
            str(k): str(v) for k, v in env["env_vars"].items()
        }
    if env.get("working_dir"):
        wire["working_dir"] = _upload_dir(env["working_dir"], worker)
    if env.get("py_modules"):
        # Each module dir is zipped under its own name so the extracted
        # cache dir is the importable parent on sys.path.
        wire["py_modules"] = [
            _upload_dir(m, worker, nest_under_name=True)
            for m in env["py_modules"]
        ]
    for name, plugin in _PLUGINS.items():
        if name in env:
            wire[name] = plugin.validate(env[name], worker)
    return wire


# Driver-side upload memo: (worker generation, realpath, dir
# signature) -> wire dict. Submitting many tasks with the same
# runtime_env must not re-zip the tree or re-download the package per
# submit (reference: URI caching in runtime_env/working_dir.py).
_upload_memo: Dict[tuple, dict] = {}


def _dir_signature(path: str) -> tuple:
    """Cheap change detector: (file count, total size, max mtime)."""
    count = total = 0
    latest = 0.0
    for root, _, files in os.walk(path):
        for name in files:
            try:
                st = os.stat(os.path.join(root, name))
            except OSError:
                continue
            count += 1
            total += st.st_size
            latest = max(latest, st.st_mtime)
    return (count, total, latest)


def _upload_dir(path: str, worker, nest_under_name: bool = False) -> dict:
    if not os.path.isdir(path):
        raise exc.RuntimeEnvSetupError(
            f"runtime_env dir {path!r} does not exist"
        )
    real = os.path.realpath(path)
    memo_key = (
        worker.generation,
        real,
        nest_under_name,
        _dir_signature(real),
    )
    cached = _upload_memo.get(memo_key)
    if cached is not None:
        return cached
    data = _zip_dir(
        path, prefix=os.path.basename(path.rstrip(os.sep))
        if nest_under_name
        else "",
    )
    digest = hashlib.sha256(data).hexdigest()[:16]
    key = f"__rt_pkg__{digest}"
    # Existence check via key listing (never downloads the package).
    if key not in worker.call("kv_keys", prefix=key).get("keys", []):
        worker.call("kv_put", key=key, value=data)
    wire = {"key": key, "hash": digest, "name": os.path.basename(path)}
    _upload_memo[memo_key] = wire
    return wire


def _normalize_pip(spec, worker) -> dict:
    """Driver-side pip spec -> wire form {packages, hash} (reference:
    pip.py accepts a list or {'packages': [...]}; the cache key is a
    hash of the normalized spec). Local wheels/dirs upload to the
    cluster KV — workers on other nodes have no shared filesystem, so
    paths must ship as content, the same way working_dir does."""
    if isinstance(spec, dict):
        packages = list(spec.get("packages") or [])
    elif isinstance(spec, (list, tuple)):
        packages = list(spec)
    else:
        raise exc.RuntimeEnvSetupError(
            f"runtime_env['pip'] must be a list of requirements or "
            f"{{'packages': [...]}}, got {type(spec).__name__}"
        )
    if not all(isinstance(p, str) for p in packages):
        raise exc.RuntimeEnvSetupError(
            "runtime_env['pip'] entries must be strings"
        )
    # Path detection follows pip's syntax (./foo, /abs, ~/x, archive
    # suffixes) — a bare requirement name that happens to collide with
    # a cwd entry stays a requirement. Hashing is content-addressed,
    # so a rebuilt wheel or edited source dir busts the env cache.
    norm: list = []
    sig = []
    for p in packages:
        px = os.path.expanduser(p)
        if _looks_like_path(p) and os.path.exists(px):
            real = os.path.realpath(px)
            if os.path.isdir(real):
                entry = {"dir": _upload_dir(real, worker)}
                sig.append("dir:" + entry["dir"]["hash"])
            else:
                entry = {"file": _upload_file(real, worker)}
                sig.append("file:" + entry["file"]["hash"])
            norm.append(entry)
        else:
            norm.append(p)
            sig.append(p)
    digest = hashlib.sha256(
        "\n".join(sorted(sig)).encode()
    ).hexdigest()[:16]
    return {"packages": norm, "hash": digest}


def _upload_file(path: str, worker) -> dict:
    """Content-address one local file (wheel/archive) into the KV."""
    with open(path, "rb") as f:
        data = f.read()
    if len(data) > _MAX_PACKAGE_BYTES:
        raise exc.RuntimeEnvSetupError(
            f"pip requirement {path!r} is {len(data)} bytes "
            f"(limit {_MAX_PACKAGE_BYTES})"
        )
    digest = hashlib.sha256(data).hexdigest()[:16]
    key = f"__rt_pkg__{digest}"
    if key not in worker.call("kv_keys", prefix=key).get("keys", []):
        worker.call("kv_put", key=key, value=data)
    return {"key": key, "hash": digest, "name": os.path.basename(path)}


def _fetch_file(entry: dict, worker) -> str:
    """Worker-side: materialize an uploaded file requirement, keeping
    its original basename (pip parses wheel names)."""
    dirpath = os.path.join(_CACHE_ROOT, "files", entry["hash"])
    path = os.path.join(dirpath, entry["name"])
    if os.path.exists(path):
        return path
    reply = worker.call("kv_get", key=entry["key"])
    if reply.get("value") is None:
        raise exc.RuntimeEnvSetupError(
            f"pip package {entry['key']} missing from cluster KV"
        )
    os.makedirs(dirpath, exist_ok=True)
    tmp = path + f".tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(reply["value"])
    os.replace(tmp, path)
    return path


_ARCHIVE_SUFFIXES = (".whl", ".tar.gz", ".zip", ".tar.bz2")


def _looks_like_path(req: str) -> bool:
    """pip's convention: only explicit path forms are paths."""
    return (
        req.startswith(("/", "./", "../", "~"))
        or req.endswith(_ARCHIVE_SUFFIXES)
        or os.sep in req
    )


def _ensure_pip_env(pip_wire: dict, worker, tool: str = "pip") -> str:
    """Worker-side: build (once per requirements hash per node) an
    isolated package dir via `pip install --target` (or uv's
    equivalent) and return it for sys.path prepending. A full
    virtualenv would add interpreter symlinks nothing executes — the
    path prepend IS the isolation unit here (the reference swaps
    worker interpreters instead, runtime_env/pip.py). Concurrency-safe
    via build-in-tmp-then-rename."""
    import subprocess

    target = os.path.join(_CACHE_ROOT, f"{tool}-" + pip_wire["hash"])
    if os.path.isdir(target):
        return target
    # Materialize uploaded local requirements (wheels/source dirs)
    # from the cluster KV onto this node first.
    reqs = []
    for entry in pip_wire["packages"]:
        if isinstance(entry, str):
            reqs.append(entry)
        elif "file" in entry:
            reqs.append(_fetch_file(entry["file"], worker))
        else:
            reqs.append(_fetch_package(entry["dir"], worker))
    os.makedirs(_CACHE_ROOT, exist_ok=True)
    tmp = target + f".tmp{os.getpid()}"
    if tool == "uv":
        # --python pins resolution to the worker's interpreter
        # (reference: runtime_env/uv.py passes the same).
        cmd = [
            "uv", "pip", "install", "--quiet",
            "--python", sys.executable, "--target", tmp, *reqs,
        ]
    else:
        cmd = [
            sys.executable, "-m", "pip", "install",
            "--quiet", "--disable-pip-version-check",
            "--no-input", "--target", tmp, *reqs,
        ]
    try:
        os.makedirs(tmp, exist_ok=True)
        try:
            proc = subprocess.run(
                cmd,
                capture_output=True,
                text=True,
                timeout=600,
            )
        except subprocess.TimeoutExpired as e:
            raise exc.RuntimeEnvSetupError(
                f"{tool} install timed out after 600s for runtime_env"
                f"{pip_wire['packages']}"
            ) from e
        if proc.returncode != 0:
            raise exc.RuntimeEnvSetupError(
                f"{tool} install failed for runtime_env"
                f"{pip_wire['packages']}:\n{proc.stderr[-2000:]}"
            )
        try:
            os.rename(tmp, target)
        except OSError:
            shutil.rmtree(tmp, ignore_errors=True)  # lost the race
    finally:
        if os.path.isdir(tmp):
            shutil.rmtree(tmp, ignore_errors=True)
    return target


def _fetch_package(pkg: dict, worker) -> str:
    """Worker-side: download + extract once per content hash."""
    target = os.path.join(_CACHE_ROOT, pkg["hash"])
    if os.path.isdir(target):
        return target
    reply = worker.call("kv_get", key=pkg["key"])
    if reply.get("value") is None:
        raise exc.RuntimeEnvSetupError(
            f"package {pkg['key']} missing from cluster KV"
        )
    os.makedirs(_CACHE_ROOT, exist_ok=True)
    tmp = target + f".tmp{os.getpid()}"
    with zipfile.ZipFile(io.BytesIO(reply["value"])) as zf:
        zf.extractall(tmp)
    try:
        os.rename(tmp, target)
    except OSError:
        # Another worker won the race; its copy is identical.
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)
    return target


@contextmanager
def apply_runtime_env(wire: Optional[dict], worker, *, restore: bool = True):
    """Worker-side: enter the env around task execution. restore=False
    for actors (they own their worker for life)."""
    if not wire:
        yield
        return
    saved_env: Dict[str, Optional[str]] = {}
    saved_path = list(sys.path)
    saved_cwd = os.getcwd()
    pip_site: Optional[str] = None
    try:
        for key, value in (wire.get("env_vars") or {}).items():
            saved_env[key] = os.environ.get(key)
            os.environ[key] = value
        if wire.get("pip"):
            import importlib

            pip_site = _ensure_pip_env(wire["pip"], worker)
            sys.path.insert(0, pip_site)
            # Subprocesses the task spawns inherit the env too.
            saved_env.setdefault(
                "PYTHONPATH", os.environ.get("PYTHONPATH")
            )
            os.environ["PYTHONPATH"] = os.pathsep.join(
                p for p in (pip_site, os.environ.get("PYTHONPATH")) if p
            )
            importlib.invalidate_caches()
        if wire.get("working_dir"):
            workdir = _fetch_package(wire["working_dir"], worker)
            os.chdir(workdir)
            sys.path.insert(0, workdir)
        for pkg in wire.get("py_modules") or []:
            sys.path.insert(0, _fetch_package(pkg, worker))
        _load_external_plugins()
        orphaned = set(wire) - _KNOWN_FIELDS - set(_PLUGINS)
        if orphaned:
            # The driver validated these through a plugin that is not
            # registered HERE (RT_RUNTIME_ENV_PLUGINS missing from the
            # worker env). Running without the requested environment
            # would be a silent wrong answer.
            raise exc.RuntimeEnvSetupError(
                f"runtime_env fields {sorted(orphaned)} have no "
                "registered plugin on this worker; set "
                "RT_RUNTIME_ENV_PLUGINS cluster-wide"
            )
        ctx = RuntimeEnvContext(worker, saved_env)
        for plugin in sorted(
            _PLUGINS.values(), key=lambda p: p.priority
        ):
            if plugin.name not in wire:
                continue
            value = wire[plugin.name]
            state_key = (plugin.name, pickle.dumps(value))
            if state_key not in _plugin_state:
                _plugin_state[state_key] = plugin.create(value, worker)
            plugin.modify_context(
                _plugin_state[state_key], value, ctx
            )
        yield
    finally:
        if restore:
            for key, value in saved_env.items():
                if value is None:
                    os.environ.pop(key, None)
                else:
                    os.environ[key] = value
            sys.path[:] = saved_path
            try:
                os.chdir(saved_cwd)
            except OSError:
                pass
            if pip_site is not None:
                # Evict the env's modules so a later task on this
                # shared worker can't import them via sys.modules
                # (the reference avoids this by dedicating workers per
                # env; we restore instead). Namespace packages have
                # __file__=None but carry the env dir in __path__.
                for name, mod in list(sys.modules.items()):
                    file = getattr(mod, "__file__", None) or ""
                    paths = list(getattr(mod, "__path__", None) or [])
                    if file.startswith(pip_site) or any(
                        str(p).startswith(pip_site) for p in paths
                    ):
                        del sys.modules[name]


# ---------------------------------------------------------------------------
# built-in plugins: uv and conda (reference: runtime_env/uv.py, conda.py)
# ---------------------------------------------------------------------------

class UvPlugin(RuntimeEnvPlugin):
    """runtime_env={"uv": ["pkg", ...]} or {"uv": {"packages": [...]}}.

    Same wire shape and node-local cache as `pip` (the spec normalizer
    and the --target package-dir builder are shared), installed by the
    uv binary instead. Gated driver-side on `uv` being on PATH so an
    image without it fails at submit, not on a remote worker."""

    name = "uv"
    priority = 5

    def validate(self, value, worker):
        if shutil.which("uv") is None:
            raise exc.RuntimeEnvSetupError(
                "runtime_env['uv'] requires the uv binary on PATH; "
                "this image does not carry it — use runtime_env"
                "['pip'] or bake dependencies into the image"
            )
        return _normalize_pip(value, worker)

    def create(self, value, worker):
        if shutil.which("uv") is None:
            raise exc.RuntimeEnvSetupError(
                "runtime_env['uv']: uv binary missing on worker node"
            )
        return _ensure_pip_env(value, worker, tool="uv")

    def modify_context(self, state, value, ctx: RuntimeEnvContext):
        ctx.prepend_sys_path(state)


class CondaPlugin(RuntimeEnvPlugin):
    """runtime_env={"conda": {"dependencies": [...]}} builds a prefix
    env once per spec hash; {"conda": "/path/env.yml"} builds from an
    environment file; {"conda": "env-name"} activates an existing
    named env. Activation = prefix bin/ onto PATH + its site-packages
    onto sys.path (the reference swaps the worker interpreter,
    conda.py; the path prepend is this runtime's isolation unit).
    Gated driver-side on the conda binary."""

    name = "conda"
    priority = 5

    def validate(self, value, worker):
        if shutil.which("conda") is None:
            raise exc.RuntimeEnvSetupError(
                "runtime_env['conda'] requires the conda binary on "
                "PATH; this image does not carry it — use runtime_env"
                "['pip'] or bake dependencies into the image"
            )
        if isinstance(value, str) and not _looks_like_path(value):
            return {"kind": "named", "name": value}
        if isinstance(value, str):
            path = os.path.realpath(os.path.expanduser(value))
            if not os.path.isfile(path):
                raise exc.RuntimeEnvSetupError(
                    f"conda environment file {value!r} not found"
                )
            with open(path, "rb") as f:
                content = f.read()
            return {
                "kind": "file",
                "content": content,
                "hash": hashlib.sha256(content).hexdigest()[:16],
            }
        if isinstance(value, dict):
            # Only keys create() actually honors may pass: silently
            # dropping e.g. "name" or a nested pip section would build
            # a DIFFERENT environment than the spec describes while
            # the hash pretends otherwise.
            unsupported = set(value) - {"dependencies", "channels"}
            if unsupported:
                raise exc.RuntimeEnvSetupError(
                    f"conda spec dict keys {sorted(unsupported)} are "
                    "not supported (supported: dependencies, "
                    "channels); use the environment-file form "
                    '({"conda": "/path/env.yml"}) for full specs'
                )
            blob = repr(sorted(value.items())).encode()
            return {
                "kind": "spec",
                "spec": value,
                "hash": hashlib.sha256(blob).hexdigest()[:16],
            }
        raise exc.RuntimeEnvSetupError(
            "runtime_env['conda'] must be an env name, an environment "
            f"file path, or a spec dict; got {type(value).__name__}"
        )

    def create(self, value, worker):
        import subprocess

        if shutil.which("conda") is None:
            raise exc.RuntimeEnvSetupError(
                "runtime_env['conda']: conda binary missing on node"
            )
        if value["kind"] == "named":
            proc = subprocess.run(
                ["conda", "run", "-n", value["name"], "python", "-c",
                 "import sys; print(sys.prefix)"],
                capture_output=True, text=True, timeout=120,
            )
            if proc.returncode != 0:
                raise exc.RuntimeEnvSetupError(
                    f"conda env {value['name']!r} not activatable:\n"
                    f"{proc.stderr[-1000:]}"
                )
            return proc.stdout.strip()
        prefix = os.path.join(_CACHE_ROOT, "conda-" + value["hash"])
        if os.path.isdir(prefix):
            return prefix
        os.makedirs(_CACHE_ROOT, exist_ok=True)
        tmp = prefix + f".tmp{os.getpid()}"
        try:
            if value["kind"] == "file":
                envfile = tmp + ".yml"
                with open(envfile, "wb") as f:
                    f.write(value["content"])
                # No -y: `conda env create` never prompts, and the
                # flag only exists on conda >= 24.3.
                cmd = ["conda", "env", "create", "-p", tmp,
                       "-f", envfile]
            else:
                deps = value["spec"].get("dependencies", [])
                bad = [d for d in deps if not isinstance(d, str)]
                if bad:
                    raise exc.RuntimeEnvSetupError(
                        "conda spec dicts support string dependencies "
                        f"only (got {bad!r}); nested pip sections need "
                        "the environment-file form: "
                        '{"conda": "/path/env.yml"}'
                    )
                channels = []
                for channel in value["spec"].get("channels", []):
                    channels += ["-c", str(channel)]
                cmd = [
                    "conda", "create", "-y", "-p", tmp,
                    *channels, *deps,
                ]
            proc = subprocess.run(
                cmd, capture_output=True, text=True, timeout=1800
            )
            if proc.returncode != 0:
                raise exc.RuntimeEnvSetupError(
                    f"conda env build failed:\n{proc.stderr[-2000:]}"
                )
            try:
                os.rename(tmp, prefix)
            except OSError:
                shutil.rmtree(tmp, ignore_errors=True)  # lost the race
        finally:
            if os.path.isdir(tmp):
                shutil.rmtree(tmp, ignore_errors=True)
            try:
                os.remove(tmp + ".yml")
            except OSError:
                pass
        return prefix

    def modify_context(self, state, value, ctx: RuntimeEnvContext):
        import glob

        ctx.set_env(
            "PATH",
            os.pathsep.join(
                p
                for p in (
                    os.path.join(state, "bin"),
                    os.environ.get("PATH"),
                )
                if p
            ),
        )
        ctx.set_env("CONDA_PREFIX", state)
        for site in glob.glob(
            os.path.join(state, "lib", "python*", "site-packages")
        ):
            ctx.prepend_sys_path(site)


register_plugin(UvPlugin())
register_plugin(CondaPlugin())
