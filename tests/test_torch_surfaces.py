"""The port's package surfaces against the JAX package's, name by name.

  * the name diff: every public name a module of ``repro`` defines (and
    every name a package ``__init__`` of it re-exports) exists in the
    module's ``repro_torch`` twin, apart from ``BY_DESIGN`` (the same
    list as ROADMAP's "By design"), and that list names only what the
    reference has and the port lacks;
  * each package ``__init__`` of the port re-exports the object its
    defining submodule holds, and the nine that mirror the reference's
    re-export exactly its names, in its order (``inference`` also
    ``BatchedExecutor``, whose reference name is ``VmapExecutor``);
  * every module of the port imports first in a fresh ``repro_torch``
    state, loading nothing of ``jax`` or ``repro``, and the port's
    module-level imports form no cycle;
  * ``configs.all_configs``, ``inference.bootstrap.SCHEMES`` and
    ``launch.dist_smoke.run_smoke`` (two gloo ranks on the CPU, spawned
    once for the module) against the reference's.
"""
import ast
import importlib
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

REPO = Path(__file__).resolve().parents[1]
SRC = REPO / "src"

# reference module -> names the port leaves out by design ("*": the whole
# module); mirrored in ROADMAP.md §A "By design"
BY_DESIGN = {
    # launch/op_cost.py counts a trace's costs: there is no XLA module
    "repro.launch.hlo_cost": "*",
    # torch cannot replay jax.random: replicates draw on generators
    "repro.inference.bootstrap": {"replicate_keys"},
    # no jit cache to miss
    "repro.inference.executor": {"jit_miss_hook"},
    # the kernels are the *_cuda wrappers, routed by the tensor's device
    "repro.kernels.flash_attention.kernel": {"flash_attention_pallas",
                                             "NEG_INF"},
    "repro.kernels.flash_attention.ops": {"default_backend"},
    "repro.kernels.residual_gram.kernel": {"residual_gram_pallas"},
    "repro.kernels.residual_gram.ops": {"default_backend"},
    "repro.kernels.seg_gram.kernel": {"seg_gram_pallas"},
    "repro.kernels.seg_gram.ops": {"default_backend", "force_backend"},
    # the plain version is seg_gram_plain
    "repro.kernels.seg_gram.ref": {"seg_gram_ref"},
    "repro.kernels.ssm_scan.kernel": {"gla_pallas", "ssd_pallas"},
    "repro.kernels.ssm_scan.ops": {"default_backend"},
    # the port traces a cell (trace_cell); there is nothing to lower
    "repro.launch.dryrun": {"lower_cell"},
    # HLO text parsing; the port counts collectives on the trace
    "repro.launch.roofline": {"CollectiveStats", "parse_collectives"},
    # lax.scan helpers; the port's stacks are the Blocks / DecoderStack
    "repro.models.transformer": {"scan_train", "scan_prefill",
                                 "scan_decode"},
    # AdamW's state is a dict of tensors
    "repro.optim": {"AdamWState"},
    "repro.optim.adamw": {"AdamWState"},
    # the port's data mesh is a process group, with no named axes
    "repro.runtime.distributed": {"DATA_AXES"},
}
# the jax.Array alias of many reference modules; the port's is torch.Tensor
BY_DESIGN_EVERYWHERE = {"Array"}

# the package __init__s whose re-exports mirror the reference's exactly
MIRRORED = ("core", "inference", "data", "checkpoint", "models",
            "kernels.seg_gram", "kernels.flash_attention",
            "kernels.residual_gram", "kernels.ssm_scan")
EXTRA = {"inference": ["BatchedExecutor"]}


def _modules(pkg: str):
    """Dotted names of every module of ``src/<pkg>``, packages included."""
    out = []
    for path in sorted((SRC / pkg).rglob("*.py")):
        parts = path.relative_to(SRC).with_suffix("").parts
        out.append(".".join(parts[:-1] if parts[-1] == "__init__" else parts))
    return out


def _path(mod: str) -> Path:
    base = SRC.joinpath(*mod.split("."))
    return base / "__init__.py" if base.is_dir() else base.with_suffix(".py")


def _reexports(mod: str, pkg: str):
    """[(alias, source module, name)] of a package ``__init__``'s
    ``from <pkg>... import`` lines, in order."""
    out = []
    for node in ast.parse(_path(mod).read_text()).body:
        if (isinstance(node, ast.ImportFrom) and node.module
                and node.module.split(".")[0] == pkg):
            out += [(a.asname or a.name, node.module, a.name)
                    for a in node.names]
    return out


def _public_names(mod: str):
    """The public names ``mod`` defines at module level, plus what its
    package ``__init__`` re-exports from the package."""
    names = []
    for node in ast.parse(_path(mod).read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.append(node.name)
        elif isinstance(node, ast.Assign):
            names += [t.id for t in node.targets if isinstance(t, ast.Name)]
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            names.append(node.target.id)
    if _path(mod).name == "__init__.py":
        names += [alias for alias, _, _ in _reexports(mod, "repro")]
    return [n for n in dict.fromkeys(names) if not n.startswith("_")]


def _twin(mod: str) -> str:
    return "repro_torch" + mod[len("repro"):]


REF_MODULES = _modules("repro")


@pytest.mark.parametrize("mod", REF_MODULES)
def test_every_reference_name_has_a_port_counterpart(mod):
    allowed = BY_DESIGN.get(mod, set())
    if allowed == "*":
        with pytest.raises(ImportError):
            importlib.import_module(_twin(mod))
        return
    twin = importlib.import_module(_twin(mod))
    missing = [n for n in _public_names(mod)
               if not hasattr(twin, n) and n not in allowed
               and n not in BY_DESIGN_EVERYWHERE]
    assert not missing, f"{_twin(mod)} lacks {missing}"


def test_the_by_design_list_names_only_what_the_port_lacks():
    for mod, names in BY_DESIGN.items():
        assert mod in REF_MODULES, mod
        if names == "*":
            assert not _path(_twin(mod)).exists(), mod
            continue
        defined = set(_public_names(mod))
        twin = importlib.import_module(_twin(mod))
        for n in names:
            assert n in defined, (mod, n)
            assert not hasattr(twin, n), (mod, n)


@pytest.mark.parametrize("pkg", [m for m in _modules("repro_torch")
                                 if _path(m).name == "__init__.py"
                                 and _reexports(m, "repro_torch")])
def test_reexports_are_the_defining_submodules_objects(pkg):
    package = importlib.import_module(pkg)
    for alias, src, name in _reexports(pkg, "repro_torch"):
        got = getattr(package, alias)
        if src == pkg:           # ``from pkg import submodule``
            want = importlib.import_module(f"{pkg}.{name}")
        else:
            want = getattr(importlib.import_module(src), name)
        assert got is want, (pkg, alias)


@pytest.mark.parametrize("sub", MIRRORED)
def test_mirrored_surfaces_reexport_exactly_the_references_names(sub):
    want = [a for a, _, _ in _reexports(f"repro.{sub}", "repro")]
    got = [a for a, _, _ in _reexports(f"repro_torch.{sub}", "repro_torch")]
    extra = EXTRA.get(sub, [])
    assert [a for a in got if a not in extra] == want
    assert sorted(set(got) - set(want)) == sorted(extra)


def test_surface_aliases():
    import repro_torch.core as core
    import repro_torch.inference as inference
    from repro_torch.inference.executor import BatchedExecutor

    assert core.DML is importlib.import_module("repro_torch.core.dml").DML
    # the function shadows the submodule, as in the reference
    assert callable(core.crossfit) and not isinstance(core.crossfit,
                                                      type(core))
    assert core.moments is importlib.import_module("repro_torch.core.moments")
    assert inference.VmapExecutor is BatchedExecutor
    assert inference.make_executor("vmap").name == "vmap"


_FRESH = r"""
import importlib, sys
bad = []
for m in sys.argv[1:]:
    for k in [k for k in sys.modules
              if k == "repro_torch" or k.startswith("repro_torch.")]:
        del sys.modules[k]
    try:
        importlib.import_module(m)
    except Exception as e:
        bad.append(f"{m}: {type(e).__name__}: {e}")
    leaked = [k for k in sys.modules if k in ("jax", "repro")
              or k.startswith(("jax.", "repro."))]
    if leaked:
        bad.append(f"{m}: loaded {leaked[:3]}")
print("\n".join(bad) if bad else "ok")
"""


def test_every_port_module_imports_first_in_a_fresh_state():
    mods = _modules("repro_torch")
    out = subprocess.run([sys.executable, "-c", _FRESH, *mods],
                         env={**os.environ, "PYTHONPATH": str(SRC)},
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "ok", out.stdout


def _module_level_imports(mod: str):
    """Modules of the port ``mod`` imports when it loads (inside a
    function or under TYPE_CHECKING does not count), each with the
    packages that import runs first; ``mod``'s own packages left out."""
    found = []

    def visit(nodes):
        for n in nodes:
            if isinstance(n, ast.ImportFrom) and n.module:
                found.append(n.module)
                found.extend(f"{n.module}.{a.name}" for a in n.names)
            elif isinstance(n, ast.Import):
                found.extend(a.name for a in n.names)
            elif isinstance(n, ast.If):
                if "TYPE_CHECKING" not in ast.dump(n.test):
                    visit(n.body)
                visit(n.orelse)
            elif isinstance(n, (ast.Try, ast.With, ast.ClassDef)):
                visit(getattr(n, "body", []))
                for h in getattr(n, "handlers", []):
                    visit(h.body)
                visit(getattr(n, "orelse", []))
                visit(getattr(n, "finalbody", []))

    visit(ast.parse(_path(mod).read_text()).body)
    known = set(_modules("repro_torch"))
    out = set()
    for name in found:
        parts = name.split(".")
        for i in range(1, len(parts) + 1):
            m = ".".join(parts[:i])
            if m in known and m != mod and not (mod + ".").startswith(m + "."):
                out.add(m)
    return out


def test_module_level_imports_form_no_cycle():
    graph = {m: _module_level_imports(m) for m in _modules("repro_torch")}
    state = {}

    def walk(m, stack):
        state[m] = "open"
        for d in sorted(graph[m]):
            if state.get(d) == "open":
                raise AssertionError(" -> ".join(stack + [m, d]))
            if d not in state:
                walk(d, stack + [m])
        state[m] = "done"

    for m in graph:
        if m not in state:
            walk(m, [])


def test_all_configs_in_the_references_order():
    from repro.configs import ARCH_IDS as J_ARCH_IDS
    from repro_torch.configs import ARCH_IDS, all_configs, get_config

    cfgs = all_configs()
    assert list(cfgs) == list(ARCH_IDS) == list(J_ARCH_IDS)
    assert all(cfgs[a] == get_config(a) for a in ARCH_IDS)


def test_bootstrap_schemes_are_the_references():
    from repro.inference.bootstrap import SCHEMES as J_SCHEMES
    from repro_torch.inference.bootstrap import SCHEMES, bootstrap_weights

    assert SCHEMES == J_SCHEMES
    for scheme in SCHEMES:
        w = bootstrap_weights(torch.Generator().manual_seed(0), 64, scheme)
        assert w.shape == (64,) and bool((w >= 0).all())


def test_run_smoke_on_two_cpu_ranks(capfd):
    from repro_torch.launch.dist_smoke import (FAIL_MARKER, OK_MARKER,
                                               run_smoke)

    assert run_smoke(nprocs=2, device="cpu") == "OK"
    out = capfd.readouterr().out
    assert OK_MARKER in out and FAIL_MARKER not in out


def test_run_smoke_fails_without_its_device():
    from repro_torch.launch import dist_smoke

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    verdict = dist_smoke.run_smoke(nprocs=2)      # the card by default
    assert verdict.startswith("FAIL: no CUDA device"), verdict
    assert dist_smoke.run_smoke(device="tpu").startswith("FAIL: device")
    assert dist_smoke.main(["--nprocs", "2"]) == 1
