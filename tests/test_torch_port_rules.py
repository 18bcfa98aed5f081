"""Rules the port keeps: it imports nothing of JAX or of ``repro``, it runs
on the CUDA card unless asked for the CPU, and its kernel wrappers take
the plain path only for CPU tensors, with no fallback."""

import ast
import os
import pathlib
import re
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs in parallel workers, and these
# small tensors gain nothing from more
torch.set_num_threads(1)

from repro_torch.device import resolve_device
from repro_torch.kernels import COUNTED, KERNELS, launches, reset_launches
from repro_torch.kernels.rule_stats.ops import segment_sum, segment_sum_tenant
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.rule_stats.ref import (rule_stats_scatter_ref,
                                                segment_sum_tenant_ref)
from repro_torch.kernels.selective_scan.ref import selective_scan_ref
from repro_torch.kernels.split_gain.ref import split_gain_ref
from repro_torch.kernels.split_poisson.ops import split_poisson
from repro_torch.kernels.split_poisson.ref import split_poisson_ref
from repro_torch.kernels.tree_route.ops import (tree_route_batched,
                                                tree_route_rows)
from repro_torch.kernels.tree_route.ref import (tree_route_batched_ref,
                                                tree_route_ref,
                                                tree_route_rows_ref)
from repro_torch.kernels.vht_stats.ref import stats_update_ref

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    files = (sorted(PORT.rglob("*.py")) + sorted((ROOT / "tools").glob("*.py"))
             + [ROOT / "chip_smoke.py"])
    assert len(files) > 10 and files[-1].exists()
    return files


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0], node.lineno


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: p.name)
def test_port_imports_no_jax_and_no_repro(path):
    bad = [(root, line) for root, line in _imported_roots(path)
           if root in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_importing_the_port_loads_no_jax():
    """Every module of the port, imported in a fresh interpreter, pulls in
    no ``jax`` and no ``repro`` module."""
    mods = sorted({".".join(p.relative_to(PORT.parent).with_suffix("").parts)
                   .removesuffix(".__init__")
                   for p in PORT.rglob("*.py")})
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]\n"
            "print(len(sys.modules)); assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


# the compiled steps and what runs them: a capture that fails must raise
COMPILED = [PORT / "core" / "compiled.py", PORT / "core" / "engines.py",
            PORT / "core" / "evaluation.py", PORT / "launch" / "serve.py"]


def test_no_fallback_handlers_in_wrappers_or_smoke():
    """No wrapper, no phase of chip_smoke.py and nothing of the compiled
    steps catches a failure."""
    paths = [PORT / "kernels" / "_build.py", ROOT / "chip_smoke.py",
             *sorted((PORT / "kernels").glob("*/ops.py")), *COMPILED]
    for path in paths:
        tree = ast.parse(path.read_text())
        handlers = [n.lineno for n in ast.walk(tree)
                    if isinstance(n, ast.ExceptHandler)]
        assert not handlers, f"{path.name} catches at lines {handlers}"


# headers of finished kernels: a kernel of the port may lean on CUTLASS's
# building blocks (atoms, layouts, copies), never on a library's kernel
LIBRARY_KERNEL_HEADERS = re.compile(
    r"^(cublas|cudnn|cusparse|cufft|flash)|cutlass/gemm/(device|kernel)/")


def _library_kernel_includes(source):
    """The #include targets of ``source`` that are library kernels."""
    return [name for name in
            re.findall(r'^\s*#\s*include\s*[<"]([^>"]+)[>"]', source, re.M)
            if LIBRARY_KERNEL_HEADERS.search(name.lower())]


def _library_calls(source):
    """Uses in ``source`` of a finished attention kernel or of
    ``torch.compile``, with their lines."""
    bad = []
    for node in ast.walk(ast.parse(source)):
        name = (node.attr if isinstance(node, ast.Attribute)
                else node.id if isinstance(node, ast.Name) else None)
        if name == "scaled_dot_product_attention" or (
                name == "compile" and isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Name)
                and node.value.id == "torch"):
            bad.append((name, node.lineno))
    return bad


def test_library_checks_catch_what_they_name():
    assert _library_kernel_includes(
        '#include <cublas_v2.h>\n#include "cutlass/gemm/device/gemm.h"\n'
        "  # include <cudnn.h>\n#include <cute/atom/mma_atom.hpp>\n"
        "#include <cuda_bf16.h>\n") == [
            "cublas_v2.h", "cutlass/gemm/device/gemm.h", "cudnn.h"]
    assert [n for n, _ in _library_calls(
        "import torch\nimport torch.nn.functional as F\n"
        "f = torch.compile(g)\nF.scaled_dot_product_attention(q, k, v)\n"
        "x = re.compile('a')\n")] == ["compile",
                                      "scaled_dot_product_attention"]


def test_the_rules_cover_the_compiled_steps():
    """core/compiled.py and its conditional-node binding are among the
    files the rules above walk."""
    assert PORT / "core" / "compiled.py" in _port_files()
    assert PORT / "csrc" / "graph_cond.cu" in sorted(
        (PORT / "csrc").glob("*.cu*"))


@pytest.mark.parametrize("path", sorted((PORT / "csrc").glob("*.cu*")),
                         ids=lambda p: p.name)
def test_kernel_sources_include_no_library_kernel(path):
    bad = _library_kernel_includes(path.read_text())
    assert not bad, f"{path.relative_to(ROOT)} includes {bad}"


@pytest.mark.parametrize("path", [*sorted((PORT / "kernels").glob("*/ops.py")),
                                  *COMPILED],
                         ids=lambda p: (p.parent.name if p.name == "ops.py"
                                        else p.stem))
def test_wrappers_call_no_library_attention_or_compile(path):
    bad = _library_calls(path.read_text())
    assert not bad, f"{path.relative_to(ROOT)} calls {bad}"


def test_default_device_is_cuda_and_raises_without_one(monkeypatch):
    from repro_torch.data.generators import RandomTreeGenerator
    from repro_torch.ml.htree import TreeConfig
    from repro_torch.ml.vht import VHT, VHTConfig, build_vht_topology
    from repro_torch.core.engines import LocalEngine
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = VHTConfig(TreeConfig(n_attrs=4))
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        VHT(cfg).init()
    with pytest.raises(RuntimeError, match="CUDA"):
        LocalEngine().init(build_vht_topology(cfg))
    with pytest.raises(RuntimeError, match="CUDA"):
        RandomTreeGenerator(n_cat=2, n_num=2)
    assert resolve_device("cpu") == torch.device("cpu")
    assert VHT(cfg, device="cpu").init()["stats"].device.type == "cpu"


def _cpu_inputs():
    g = torch.Generator().manual_seed(0)
    stats = torch.randint(0, 5, (8, 6, 4, 2), generator=g).float()
    leaf = torch.randint(0, 8, (16,), generator=g, dtype=torch.int32)
    xbin = torch.randint(0, 4, (16, 6), generator=g, dtype=torch.int32)
    y = torch.randint(0, 2, (16,), generator=g, dtype=torch.int32)
    w = torch.ones(16)
    sa = torch.tensor([0, -1, -1], dtype=torch.int32)
    sb = torch.tensor([1, 0, 0], dtype=torch.int32)
    ch = torch.tensor([[1, 2], [0, 0], [0, 0]], dtype=torch.int32)
    mom = torch.rand((16, 3), generator=g)
    return stats, leaf, xbin, y, w, sa, sb, ch, mom


NO_LAUNCHES = {"tree_route": 0, "vht_stats": 0, "split_gain": 0,
               "rule_stats": 0, "selective_scan": 0, "flash_attention": 0,
               "segment_sum": 0, "split_poisson": 0,
               "tree_route_batched": 0, "tree_route_rows": 0,
               "segment_sum_tenant": 0}


def _fleet_inputs(xbin, leaf, mom):
    """The fleet forms' inputs from _cpu_inputs': two trees (the one tree
    twice) with a batch each, a tree per row, and two tenants' sums."""
    sa = torch.tensor([[0, -1, -1], [-1, 0, 0]], dtype=torch.int32)
    sb = torch.tensor([[1, 0, 0], [0, 0, 0]], dtype=torch.int32)
    ch = torch.tensor([[[1, 2], [0, 0], [0, 0]]] * 2, dtype=torch.int32)
    member = (leaf % 2).to(torch.int32)
    out = torch.zeros((2, 8, 3))
    return sa, sb, ch, xbin.reshape(2, 8, -1), member, out


def _lm_inputs(device="cpu"):
    """selective_scan's (dt, x, Bm, Cm, A, h0) and flash_attention's (q, k,
    v), small, on ``device``."""
    g = torch.Generator().manual_seed(1)
    scan = [torch.rand(shape, generator=g) * 0.1 for shape in
            ((2, 5, 8), (2, 5, 8), (2, 5, 4), (2, 5, 4))]
    scan += [-torch.rand((8, 4), generator=g), torch.zeros((2, 8, 4))]
    qkv = [torch.randn((1, 7, 4, 16), generator=g),
           torch.randn((1, 7, 2, 16), generator=g),
           torch.randn((1, 7, 2, 16), generator=g)]
    return [t.to(device) for t in scan], [t.to(device) for t in qkv]


def _poisson_inputs(device="cpu"):
    """split_poisson's key and boosting-like rates [3, 16], on ``device``."""
    from repro_torch.core.prng import PRNGKey
    lam = 1.0 + 2.0 * torch.rand((3, 16), generator=torch.Generator()
                                 .manual_seed(2))
    return PRNGKey(5, "cpu").to(device), lam.to(device)


def test_wrappers_take_the_plain_path_on_cpu_without_counting():
    stats, leaf, xbin, y, w, sa, sb, ch, mom = _cpu_inputs()
    reset_launches()
    got = KERNELS["vht_stats"](stats.clone(), leaf, xbin, y, w)
    assert torch.equal(got, stats_update_ref(stats.clone(), leaf, xbin, y, w))
    assert torch.equal(KERNELS["split_gain"](stats), split_gain_ref(stats))
    assert torch.equal(KERNELS["tree_route"](sa, sb, ch, xbin, max_depth=4),
                       tree_route_ref(sa[None], sb[None], ch[None], xbin, 4)[0])
    rstats = stats[..., :1].expand(8, 6, 4, 3).contiguous()
    assert torch.equal(KERNELS["rule_stats"](rstats.clone(), leaf, xbin, mom),
                       rule_stats_scatter_ref(rstats.clone(), leaf, xbin, mom))
    assert torch.equal(segment_sum(rstats.clone(), leaf, xbin, mom),
                       rule_stats_scatter_ref(rstats.clone(), leaf, xbin, mom))
    scan, qkv = _lm_inputs()
    for got, want in zip(KERNELS["selective_scan"](*scan),
                         selective_scan_ref(*scan)):
        assert torch.equal(got, want)
    assert torch.equal(KERNELS["flash_attention"](*qkv, window=3),
                       flash_attention_ref(*qkv, window=3))
    key, lam = _poisson_inputs()
    for got, want in zip(split_poisson(key, lam, (3, 16)),
                         split_poisson_ref(key, lam, (3, 16))):
        assert got.dtype == want.dtype and torch.equal(got, want)
    fsa, fsb, fch, fxb, member, out = _fleet_inputs(xbin, leaf, mom)
    assert torch.equal(tree_route_batched(fsa, fsb, fch, fxb, max_depth=4),
                       tree_route_batched_ref(fsa, fsb, fch, fxb, 4))
    assert torch.equal(tree_route_rows(fsa, fsb, fch, xbin, member,
                                       max_depth=4),
                       tree_route_rows_ref(fsa, fsb, fch, xbin, member, 4))
    assert torch.equal(segment_sum_tenant(out.clone(), leaf, mom),
                       segment_sum_tenant_ref(out.clone(), leaf, mom))
    assert launches() == NO_LAUNCHES


def test_wrappers_refuse_a_device_that_is_neither_cpu_nor_cuda():
    """A tensor that is not on the CPU goes to the kernel or raises; it is
    never run through the plain version."""
    stats, leaf, xbin, y, w, sa, sb, ch, mom = [t.to("meta")
                                                for t in _cpu_inputs()]
    reset_launches()
    with pytest.raises(ValueError):
        KERNELS["vht_stats"](stats, leaf, xbin, y, w)
    with pytest.raises(ValueError):
        KERNELS["split_gain"](stats)
    with pytest.raises(ValueError):
        KERNELS["tree_route"](sa, sb, ch, xbin, max_depth=4)
    with pytest.raises(ValueError):
        KERNELS["rule_stats"](torch.zeros((8, 6, 4, 3), device="meta"), leaf,
                              xbin, mom)
    with pytest.raises(ValueError):
        segment_sum(torch.zeros((8, 6, 4, 3), device="meta"), leaf, xbin, mom)
    scan, qkv = _lm_inputs("meta")
    with pytest.raises(ValueError):
        KERNELS["selective_scan"](*scan)
    with pytest.raises(ValueError):
        KERNELS["flash_attention"](*qkv)
    key, lam = _poisson_inputs("meta")
    with pytest.raises(ValueError):
        split_poisson(key, lam, (3, 16))
    fsa, fsb, fch, fxb, member, out = [
        t.to("meta") for t in _fleet_inputs(xbin, leaf, mom)]
    with pytest.raises(ValueError):
        tree_route_batched(fsa, fsb, fch, fxb, max_depth=4)
    with pytest.raises(ValueError):
        tree_route_rows(fsa, fsb, fch, xbin, member, max_depth=4)
    with pytest.raises(ValueError):
        segment_sum_tenant(out, leaf, mom)
    assert launches() == NO_LAUNCHES


def test_amrules_default_device_is_cuda_and_raises_without_one(monkeypatch):
    from repro_torch.core.engines import LocalEngine
    from repro_torch.data.generators import WaveformGenerator
    from repro_torch.ml.amrules import HAMR, VAMR, AMRules, RulesConfig
    from repro_torch.ml.detectors import DetectorBank
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = RulesConfig(n_attrs=4)
    for learner in (AMRules(rc), VAMR(rc), HAMR(rc)):
        with pytest.raises(RuntimeError, match="CUDA"):
            learner.init()
    with pytest.raises(RuntimeError, match="CUDA"):
        LocalEngine().init(AMRules(rc))
    with pytest.raises(RuntimeError, match="CUDA"):
        DetectorBank("ph_ema", 4).init()
    with pytest.raises(RuntimeError, match="CUDA"):
        WaveformGenerator()
    assert AMRules(rc, device="cpu").init()["stats"].device.type == "cpu"



def test_split_poisson_is_counted_apart_from_the_tpu_counterparts():
    """split_poisson replaces no TPU kernel: its launches are counted, but
    it is not among the counterparts of the JAX package's Pallas kernels."""
    assert COUNTED["split_poisson"] is split_poisson
    assert "split_poisson" not in KERNELS
    assert (PORT / "csrc" / "split_poisson.cu").exists()


def test_ensembles_default_device_is_cuda_and_raise_without_one(monkeypatch):
    from repro_torch.core.engines import JitEngine
    from repro_torch.core.evaluation import PrequentialEvaluation
    from repro_torch.data.generators import (CovtypeLikeGenerator,
                                             RandomTweetGenerator)
    from repro_torch.ml.ensemble import EnsembleConfig, OzaEnsemble
    from repro_torch.ml.htree import TreeConfig
    from repro_torch.ml.vht import ShardingEnsemble
    from repro_torch.core.prng import PRNGKey
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tc = TreeConfig(n_attrs=4)
    for make in (lambda: OzaEnsemble(EnsembleConfig(tc)).init(),
                 lambda: ShardingEnsemble(tc, 2).init(),
                 lambda: JitEngine().init(ShardingEnsemble(tc, 2)),
                 lambda: PrequentialEvaluation(ShardingEnsemble(tc, 2),
                                               []).run(),
                 lambda: PRNGKey(0), CovtypeLikeGenerator,
                 RandomTweetGenerator):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    state = OzaEnsemble(EnsembleConfig(tc), device="cpu").init()
    assert state["trees"]["stats"].device.type == "cpu"
    assert state["key"].device.type == "cpu"
    assert ShardingEnsemble(tc, 2, device="cpu").init()["stats"].shape[0] == 2


def test_lm_default_device_is_cuda_and_raises_without_one(monkeypatch):
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import serve
    from repro_torch.models import LanguageModel, init_params, param_defs
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke_config("qwen15_4b")
    with pytest.raises(RuntimeError, match="CUDA"):
        init_params(param_defs(cfg))
    with pytest.raises(RuntimeError, match="CUDA"):
        LanguageModel.init(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", "qwen15_4b", "--smoke"])
    model = LanguageModel.init(cfg, device="cpu")
    assert model.device.type == "cpu"
    assert model.init_cache(1, 4)["body"][0]["k"].device.type == "cpu"
