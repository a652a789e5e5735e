"""The layer under the kernel wrappers of ``ssme_tpu_torch/ops/``: one
launch call and one launch count (``_cuda``), one step-block cache of the
plain versions' draws (``_prng``), and wrappers that reach into no other
wrapper."""

import ast
import os

import pytest
import torch

from ssme_tpu_torch.models.svol_leverage import lagged_covariates
from ssme_tpu_torch.ops import _cuda, _prng
from ssme_tpu_torch.ops import filter_megakernel as fm
from ssme_tpu_torch.ops import liu_west_megakernel as lwm
from ssme_tpu_torch.ops import svol_filter_kernel as sfk

torch.set_num_threads(1)

OPS = os.path.dirname(_cuda.__file__)
# the modules every other one in ops/ may reach into
SHARED = {"_cuda", "_prng", "_select"}
# the three launch wrappers: K1, K2, K3
WRAPPERS = {"svol_filter_kernel", "filter_megakernel", "liu_west_megakernel"}


class _FakeLibrary:
    """C entries that record their calls and return ``codes[name]``."""

    def __init__(self, codes):
        self.codes, self.calls = codes, []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return self.codes.get(name, 0)
        return entry


@pytest.fixture
def fake_library(monkeypatch):
    lib = _FakeLibrary({"ssme_roll_select": -3})
    monkeypatch.setattr(_cuda, "library", lambda: lib)
    monkeypatch.setattr(_cuda, "stream_ptr", lambda device: 77)
    monkeypatch.setattr(_cuda, "_launches", {})
    return lib


def test_launch_counts_each_call_under_its_entry_and_key(fake_library):
    _cuda.launch("ssme_filter_megakernel", 1, 2, device="cuda",
                 key="factor_svol_5")
    _cuda.launch("ssme_filter_megakernel", 3, device="cuda", key="svol")
    _cuda.launch("ssme_filter_megakernel", 4, device="cuda", key="svol")
    _cuda.launch("ssme_filter_megakernel_spans", 5, device="cuda",
                 key="svol")
    _cuda.launch("ssme_svol_filter", device="cuda")
    # the stream comes last; the SVOL kernel's twin calls its C entry
    _cuda.launch("ssme_svol_filter_spans", 6, device="cuda")
    assert fake_library.calls == [
        ("ssme_filter_megakernel", (1, 2, 77)),
        ("ssme_filter_megakernel", (3, 77)),
        ("ssme_filter_megakernel", (4, 77)),
        ("ssme_filter_megakernel_spans", (5, 77)),
        ("ssme_svol_filter", (77,)),
        ("ssme_svol_filter", (6, 77))]
    assert _cuda.launches("ssme_filter_megakernel", "factor_svol_5") == 1
    assert _cuda.launches("ssme_filter_megakernel", "svol") == 2
    assert _cuda.launches("ssme_filter_megakernel") == 3   # every key
    assert _cuda.launches("ssme_filter_megakernel", "svol_t") == 0
    # a twin counts apart from its kernel
    assert _cuda.launches("ssme_filter_megakernel_spans") == 1
    assert _cuda.launches("ssme_svol_filter") == 1
    assert _cuda.launches("ssme_svol_filter", None) == 1
    assert _cuda.launches("ssme_svol_filter_spans") == 1


def test_a_failed_launch_raises_and_counts_nothing(fake_library):
    with pytest.raises(RuntimeError, match="ssme_roll_select: CUDA error -3"):
        _cuda.launch("ssme_roll_select", 1, device="cuda")
    assert _cuda.launches("ssme_roll_select") == 0
    assert fake_library.calls == [("ssme_roll_select", (1, 77))]


def test_a_query_goes_through_the_call_path_uncounted(fake_library):
    _cuda.call("ssme_lw_megakernel_clusters", 0, 512, None)
    assert fake_library.calls == [("ssme_lw_megakernel_clusters",
                                   (0, 512, None))]
    assert _cuda.launches("ssme_lw_megakernel_clusters") == 0
    fake_library.codes["ssme_svol_step_grid"] = 2
    with pytest.raises(RuntimeError, match="CUDA error 2"):
        _cuda.call("ssme_svol_step_grid", 8, 64, None)


def _ops_imports(path):
    """(module imported, name or None) for each import of an ops/
    module in the source ``path``, and the attributes read off the
    modules it binds to a name."""
    with open(path) as f:
        tree = ast.parse(f.read())
    pairs, aliases = [], {}
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module and \
                node.module.startswith("ssme_tpu_torch.ops"):
            parts = node.module.split(".")
            for a in node.names:
                if len(parts) == 2:         # from ssme_tpu_torch.ops import m
                    pairs.append((a.name, None))
                    aliases[a.asname or a.name] = a.name
                else:
                    pairs.append((parts[2], a.name))
        elif isinstance(node, ast.Import):
            for a in node.names:
                if a.name.startswith("ssme_tpu_torch.ops."):
                    pairs.append((a.name.split(".")[2], None))
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute) and \
                isinstance(node.value, ast.Name) and node.value.id in aliases:
            pairs.append((aliases[node.value.id], node.attr))
    return pairs


MODULES = sorted(f[:-3] for f in os.listdir(OPS) if f.endswith(".py"))


@pytest.mark.parametrize("name", MODULES)
def test_no_ops_module_reaches_into_another_but_the_shared_ones(name):
    assert WRAPPERS <= set(MODULES) and SHARED <= set(MODULES)
    for module, attr in _ops_imports(os.path.join(OPS, name + ".py")):
        if module != name and module not in SHARED:
            assert attr is None or not attr.startswith("_"), (
                f"ops/{name}.py reads {module}.{attr}")
        if name in WRAPPERS:
            assert module not in WRAPPERS - {name}, (
                f"ops/{name}.py imports ops/{module}.py")


def test_the_import_check_sees_what_it_forbids(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text(
        "from ssme_tpu_torch.ops.svol_filter_kernel import _launch\n"
        "from ssme_tpu_torch.ops import filter_megakernel as k2\n"
        "k2._validate\n")
    assert _ops_imports(str(probe)) == [
        ("svol_filter_kernel", "_launch"), ("filter_megakernel", None),
        ("filter_megakernel", "_validate")]


def _leverage_inputs(t_len):
    g = torch.Generator().manual_seed(21)
    ys = 0.8 * torch.randn(t_len, generator=g)
    return ys, lagged_covariates(ys)[:, 0].contiguous()


def _k1(rs):
    ys, _ = _leverage_inputs(30)
    p = torch.tensor([[1.0, 0.9, 0.2], [0.8, 0.95, 0.3]] * 2)
    return (sfk.svol_filter_reference(7, p, ys, 64, 1.0, 1, rs, 8)
            + sfk.svol_filter_reference(7, p, ys, 64, 0.5, 4, rs, 8))


def _k2(rs):
    ys, zs = _leverage_inputs(30)
    p = torch.tensor([[0.95, -0.5, 0.2, -0.4], [0.9, 0.1, 0.3, -0.2]] * 2)
    km = fm.svol_leverage_kernel_model()
    out = []
    for mode in ("bootstrap", "apf"):
        tot, lcl, fmean, cloud, lw = fm.filter_megakernel_reference(
            km, 5, p, ys, zs, 64, 1.0, 1, True, mode, rs, 8)
        out += [tot, lcl, fmean, *cloud, lw]
    two = fm.factor_svol_kernel_model(3)
    pf = torch.tensor([[0.9, 0.8, -0.5, -1.0, 0.2, 0.3]
                       + [0.5, 0.1] * 3 + [0.3] * 3] * 4)
    yf = torch.stack([ys, -ys, 0.5 * ys], dim=-1).contiguous()
    return tuple(out) + fm.filter_megakernel_reference(
        two, 4, pf, yf, None, 64, 0.5, 1, False, "bootstrap", rs, 8)


def _k3(rs):
    ys, zs = _leverage_inputs(30)
    km = lwm.svol_leverage_lw_kernel_model()
    out = []
    for variant, ess in (("apf", 0.0), ("sisr", 0.0), ("apf", 0.5)):
        res = lwm.lw_megakernel_reference(km, 9, ys, zs, 4, 64, 0.99, 1,
                                          variant, ess, rs, 8)
        out += [res["log_cond_likes"], res["cloud"]]
    return tuple(out)


@pytest.mark.parametrize("resampler", ["systematic", "rejection"])
@pytest.mark.parametrize("plain", [_k1, _k2, _k3], ids=["k1", "k2", "k3"])
def test_plain_versions_give_the_same_bits_at_every_block_split(
        monkeypatch, plain, resampler):
    """The shared step-block cache's contract: blocks of one step, and
    of a few steps that split T=30 unevenly, give the plain versions'
    bits at the default block size (one block for all 30 steps)."""
    want = plain(resampler)
    for elements in (1, 3 * 4 * 64 * 5):
        monkeypatch.setattr(_prng, "BLOCK_ELEMENTS", elements)
        got = plain(resampler)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert torch.equal(a, b), elements


def test_step_blocks_start_where_the_steps_leave_the_block(monkeypatch):
    monkeypatch.setattr(_prng, "BLOCK_ELEMENTS", 3 * 2 * 32)
    seed, rows = _prng.seed_words(4), torch.arange(2)
    blocks = _prng.StepBlocks(seed, rows, 32, 10)
    assert blocks.span == 3
    want = _prng.normals_steps(seed, rows, torch.arange(10), 32, draw=1)
    offs = _prng.offsets_steps(seed, rows, torch.arange(10))
    for t in (0, 2, 3, 7, 9):
        assert torch.equal(blocks.normals(t, 1), want[t])
        assert torch.equal(blocks.offsets(t), offs[t])
    assert blocks.start == 7 and blocks.steps.tolist() == [7, 8, 9]
