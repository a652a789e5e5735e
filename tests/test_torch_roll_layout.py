"""The roll resamplers' schedule on the card (``csrc/roll_select.cuh``:
shift scans by chunks of 32 sweeps, a vote per chunk, a sweep-parallel
tail), modelled in ``ops/_select.py::roll_schedule``, against the plain
laws ``metropolis_ancestors`` / ``rejection_ancestors`` and against the
JAX package's ``metropolis_select_leaves`` / ``rejection_select_leaves``
in an interpret-mode ``pallas_call``; and the constants and layout the
kernels' sources and the Python side share.

The JAX comparisons use ``tests/test_torch_roll_select.py``'s tape of
words, on which both sides' accept uniforms are equal (its docstring).
"""

import functools
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from ssme_tpu.ops import _select as jsel
from ssme_tpu_torch.ops import _prng
from ssme_tpu_torch.ops import _select as sel
from ssme_tpu_torch.ops import filter_megakernel as fm
from ssme_tpu_torch.ops import liu_west_megakernel as lwm
from ssme_tpu_torch.ops import svol_filter_kernel as sfk

torch.set_num_threads(1)
B = 4
CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "ssme_tpu_torch", "csrc")
# each kernel's kPer at each N under the roll resamplers: the generic
# kernel's (filter_megakernel_sys.cuh kper_for), the SVOL kernel's
# (svol_filter_sys.cu kper_for) and the Liu-West kernel's
# (lw_megakernel_sys.cuh roll_kper_for)
K2_KPER = {32: 2, 512: 2, 1024: 4, 2048: 8, 4096: 16}
K1_ROLL_KPER = {32: 2, 512: 2, 1024: 4, 2048: 8, 4096: 16}
K3_ROLL_KPER = {32: 2, 512: 2, 1024: 2, 2048: 4, 4096: 8}


def _weights(case, n, seed):
    rng = np.random.default_rng(seed)
    w = rng.gamma(1.0, 1.0, (B, n)).astype(np.float32)
    if case == "dominant":
        w *= np.float32(1e-12)
        w[np.arange(B), rng.integers(0, n, B)] = 1.0
    elif case == "zero_runs":
        for r in range(B):
            for _ in range(3):
                a = rng.integers(0, n)
                w[r, a:a + rng.integers(n // 8, n // 2)] = 0.0
    elif case == "peaked":
        w = rng.gamma(0.05, 1.0, (B, n)).astype(np.float32)
    return torch.from_numpy(w)


def _layouts(n):
    """The kPers the roll families run at N (kPer neighbouring slots a
    thread in every kernel)."""
    return sorted({K2_KPER[n], K1_ROLL_KPER[n], K3_ROLL_KPER[n]})


@pytest.mark.parametrize("n", [32, 512, 2048, 4096])
@pytest.mark.parametrize("case", ["random", "dominant", "zero_runs"])
def test_schedule_gives_the_rejection_law_bit_for_bit(case, n):
    """Every kernel's layout and tail threshold (0: never, the kernels'
    32, and every row at its first vote) gives the ancestors of the
    sequential law, and the record's sweeps are 1 + the last accept
    sweep.  Dominant weights above N = 32 run most slots for thousands of
    sweeps: one row, the kernels' threshold."""
    w = _weights(case, n, n)
    tails = (0, sel.ROLL_TAIL_THREADS, n)
    if case == "dominant" and n > 32:
        w, tails = w[:1], (sel.ROLL_TAIL_THREADS,)
    draw = sel.philox_draw(_prng.seed_words(n + 1),
                           torch.arange(w.shape[0]), 3, n)
    want, when = sel.rejection_accepts(w, draw)
    sweeps = torch.clamp(when.amax(-1) + 1, max=_prng.ROLL_MAX_ITERS)
    for kper in _layouts(n):
        for tail in tails:
            anc, rec = sel.roll_schedule("rejection", w, draw, kper=kper,
                                         tail_threads=tail)
            assert torch.equal(anc, want), (kper, tail)
            assert torch.equal(rec["sweeps"], sweeps)
            assert (rec["votes"] >= 1).all()
            if tail == n:      # the tail from the first vote on
                assert (rec["votes"] == 1).all()
            if tail == 0:
                assert (rec["tail_slots"] == 0).all()


@pytest.mark.parametrize("n", [32, 512, 2048, 4096])
def test_schedule_gives_the_metropolis_law_bit_for_bit(n):
    """Chains of 70 sweeps: three chunks of shifts, the last one partial."""
    w = _weights("random", n, n + 2)
    draw = sel.philox_draw(_prng.seed_words(5), torch.arange(B), 8, n)
    anc, rec = sel.roll_schedule("metropolis", w, draw, metropolis_iters=70)
    assert torch.equal(anc, sel.metropolis_ancestors(w, draw, 70))
    assert (rec["sweeps"] == 70).all() and (rec["votes"] == 0).all()


@pytest.mark.parametrize("n", [32, 512])
def test_a_row_at_the_cap_keeps_every_pending_slot(n):
    """A row of zero weights never accepts: 4096 sweeps, every slot keeps
    itself, in the bulk and in the tail; beside it a row of one heavy
    particle drains every slot to it."""
    w = torch.zeros((2, n))
    w[1, 5] = 1.0
    draw = sel.philox_draw(_prng.seed_words(9), torch.arange(2), 1, n)
    for tail in (0, sel.ROLL_TAIL_THREADS):
        anc, rec = sel.roll_schedule("rejection", w, draw, kper=2,
                                     tail_threads=tail)
        assert torch.equal(anc[0], torch.arange(n))
        assert (anc[1] == 5).all()
        assert int(rec["sweeps"][0]) == _prng.ROLL_MAX_ITERS
        assert torch.equal(anc, sel.rejection_ancestors(w, draw))


@pytest.mark.parametrize("resampler", ["metropolis", "rejection"])
def test_schedule_on_the_apf_first_stage_tags(resampler):
    """The first stage's sweep tags (0xE0000000 + s) give other draws than
    the resample's, and the schedule still the law's ancestors."""
    n = 512
    w = _weights("random", n, 17)
    out = []
    for tag in (_prng.TAG_ROLL_SWEEP, _prng.TAG_ROLL_SELECT):
        draw = sel.philox_draw(_prng.seed_words(4), torch.arange(B), 6, n,
                               tag)
        anc, _ = sel.roll_schedule(resampler, w, draw, metropolis_iters=40,
                                   kper=2)
        assert torch.equal(anc, sel.roll_ancestors(resampler, w, draw, 40))
        out.append(anc)
    assert not torch.equal(out[0], out[1])


def _uniform_words(rng, shape):
    """(JAX int32 words, port words) giving equal uniforms."""
    k = rng.integers(2 ** 16 - 1, 2 ** 24 - 1, size=shape, dtype=np.int64)
    return ((k + 1) * 256 - 2 ** 31).astype(np.int32), k << 8


def _tape_draw(shifts, uniforms):
    def draw(s, k, sub):
        sh = torch.from_numpy(shifts[s:s + k] & 0xFFFFFFFF)
        u = _prng.uniform_open_zero(torch.from_numpy(uniforms[s:s + k]))
        if sub is not None:
            u = u[:, sub]
        return sh[:, None].expand(k, u.shape[1]), u
    return draw


@functools.lru_cache(maxsize=None)
def _jax_rejection(b, n, max_iters):
    def kernel(w_ref, tape_ref, ids_ref, out_ref):
        def draw_bits_at(t, shape):
            if shape == (1, 1):
                return tape_ref[t, pl.dslice(0, 1)][None, :]
            k = int(np.prod(shape))
            return tape_ref[t, pl.dslice(1, k)].reshape(shape)

        (out_ref[:],) = jsel.rejection_select_leaves(
            w_ref[:], [ids_ref[:]], None, max_iters=max_iters,
            draw_bits_at=draw_bits_at)

    return jax.jit(pl.pallas_call(kernel, out_shape=jax.ShapeDtypeStruct(
        (b, n), jnp.float32), interpret=True))


@functools.lru_cache(maxsize=None)
def _jax_metropolis(b, n, num_iters):
    def kernel(w_ref, bits_ref, ids_ref, out_ref):
        counter = [0]

        def draw_bits(shape):
            k = int(np.prod(shape))
            flat = bits_ref[0, counter[0]:counter[0] + k]
            counter[0] += k
            return flat.reshape(shape)

        (out_ref[:],) = jsel.metropolis_select_leaves(
            w_ref[:], [ids_ref[:]], draw_bits, num_iters=num_iters)

    return jax.jit(pl.pallas_call(kernel, out_shape=jax.ShapeDtypeStruct(
        (b, n), jnp.float32), interpret=True))


@pytest.mark.parametrize("weights", ["peaked", "one_heavy"])
def test_schedule_equals_jax_rejection_on_one_tape(weights):
    """Over 256 sweeps, so that rows run past several chunks and tails."""
    rng = np.random.default_rng(31 if weights == "peaked" else 32)
    n, max_iters = 128, 256
    if weights == "peaked":
        w = rng.gamma(0.1, 1.0, (B, n)).astype(np.float32)
    else:
        w = np.full((B, n), 0.05, np.float32)
        w[:, 70] = 5.0
    shifts = rng.integers(-2 ** 31, 2 ** 31, size=max_iters, dtype=np.int64)
    u_jax, u_port = _uniform_words(rng, (max_iters, B, n))
    tape = np.concatenate([shifts.astype(np.int32)[:, None],
                           u_jax.reshape(max_iters, -1)], axis=1)
    ids = np.tile(np.arange(n, dtype=np.float32), (B, 1))
    got_jax = np.asarray(_jax_rejection(B, n, max_iters)(
        jnp.asarray(w), jnp.asarray(tape), jnp.asarray(ids)))
    draw = _tape_draw(shifts, u_port)
    for kper in (2, 16):
        anc, rec = sel.roll_schedule("rejection", torch.from_numpy(w), draw,
                                     kper=kper, max_iters=max_iters)
        np.testing.assert_array_equal(anc.numpy(), got_jax.astype(np.int64))
    assert (rec["sweeps"] > sel.ROLL_CHUNK).any()


def test_schedule_equals_jax_metropolis_on_one_tape():
    """40 sweeps: a whole chunk of shifts and part of the next."""
    rng = np.random.default_rng(33)
    n, iters = 256, 40
    w = rng.gamma(0.3, 1.0, (B, n)).astype(np.float32)
    shifts = rng.integers(-2 ** 31, 2 ** 31, size=iters, dtype=np.int64)
    u_jax, u_port = _uniform_words(rng, (iters, B, n))
    bits = np.concatenate([shifts.astype(np.int32),
                           u_jax.reshape(-1)])[None, :]
    ids = np.tile(np.arange(n, dtype=np.float32), (B, 1))
    got_jax = np.asarray(_jax_metropolis(B, n, iters)(
        jnp.asarray(w), jnp.asarray(bits), jnp.asarray(ids)))
    anc, _ = sel.roll_schedule("metropolis", torch.from_numpy(w),
                               _tape_draw(shifts, u_port),
                               metropolis_iters=iters)
    np.testing.assert_array_equal(anc.numpy(), got_jax.astype(np.int64))


def _source(name):
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


def test_the_schedule_constants_are_the_kernels():
    src = _source("roll_select.cuh")
    consts = dict(re.findall(r"constexpr int (kRoll\w+) = (\d+);", src))
    assert int(consts["kRollChunk"]) == sel.ROLL_CHUNK
    assert int(consts["kRollTailThreads"]) == sel.ROLL_TAIL_THREADS
    assert int(consts["kRollMaxIters"]) == _prng.ROLL_MAX_ITERS


def test_the_generic_kernels_roll_layout_and_instances():
    """kper_for gives each N its kPer within 256 threads, and every kPer
    of the roll family has its instance file, launched through the same
    template as the systematic family's."""
    src = _source("filter_megakernel_sys.cuh")
    body = re.search(r"inline int kper_for\(int n\) \{\s*return (.*?);",
                     src, re.S).group(1)
    steps = [(int(a), int(k)) for a, k in
             re.findall(r"n <= (\d+) \? (\d+) :", body)]
    last = int(re.search(r": (\d+)$", body.strip()).group(1))
    for n, kper in K2_KPER.items():
        got = next((k for a, k in steps if n <= a), last)
        assert got == kper, (n, got)
        assert n // kper <= 256
    for kper in sorted(set(K2_KPER.values())):
        inst = _source(f"filter_megakernel_sys_roll{kper}.cu")
        assert f"dispatch_family<{kper}, true>" in inst
        assert f"dispatch_spans<{kper}, true>" in inst
    for kper in (2, 4):
        assert f"dispatch_family<{kper}, false>" in _source(
            f"filter_megakernel_sys{kper}.cu")
    assert not os.path.exists(os.path.join(CSRC, "filter_megakernel_roll1.cu"))
    assert "__global__" not in _source("filter_megakernel.cuh")


def test_the_twins_record_is_the_kernels():
    """SysSpan's order is SPAN_RECORD's, and the twins the Python side
    names are those the C entry dispatches."""
    src = _source("filter_megakernel_sys.cuh")
    enum = re.search(r"enum SysSpan \{(.*?)\};", src, re.S).group(1)
    names = [re.sub(r"(?<!^)([A-Z])", r"_\1", e.strip()[len("kSpan"):]).lower()
             for e in enum.split(",") if e.strip().startswith("kSpan")]
    rename = {"bar_resample": "barriers_resample",
              "bar_check": "barriers_check", "bar_other": "barriers_other",
              "bar_apf": "barriers_apf", "layout_per": "kper",
              "layout_threads": "threads", "tail_bars": "tail_barriers"}
    assert tuple(rename.get(n, n) for n in names) == fm.SPAN_RECORD
    assert "launch_sys<ssme::SvolModel, false, kPer, true, true>" in src
    assert fm.SPAN_TWINS["roll"][-1] == ("svol", "bootstrap")


def test_step_spans_refuses_a_functor_without_a_twin():
    ys = torch.zeros(8)
    with pytest.raises(ValueError, match="no instrumented twin"):
        fm.step_spans(1, torch.ones(4, 3), ys, None, 64,
                      kmodel=fm.svol_kernel_model())
    with pytest.raises(ValueError, match="the card's"):
        fm.step_spans(1, torch.ones(4, 3), ys, None, 64,
                      resampler="rejection", kmodel=fm.svol_kernel_model())


def _snake(names, prefix):
    """CamelCase enum entries after ``prefix`` -> snake_case names."""
    return [re.sub(r"(?<!^)([A-Z])", r"_\1", e[len(prefix):]).lower()
            for e in names]


def _enum(src, name):
    body = re.search(rf"enum {name} \{{(.*?)\}};", src, re.S).group(1)
    return [e.strip() for e in body.split(",") if e.strip()]


# the twins' record names of the sources' enums, renamed as the Python
# side reads them
_RENAME = {"bar_resample": "barriers_resample",
           "bar_check": "barriers_check", "bar_other": "barriers_other",
           "bar_first_resample": "barriers_first_resample",
           "bar_first_other": "barriers_first_other",
           "layout_per": "kper", "layout_threads": "threads",
           "tail_bars": "tail_barriers"}


def test_the_svol_kernels_roll_layout_and_instances():
    """kper_for gives each N its kPer under the roll resamplers within
    256 threads, each roll kPer has an instance (and so a twin) in the
    template the systematic family runs, the strided kernel is gone, and
    the twins' record is the order SPAN_RECORD reads."""
    src = _source("svol_filter_sys.cu")
    body = re.search(r"int kper_for\(int n, bool roll\) \{(.*?)\n\}", src,
                     re.S).group(1)
    above, roll_kper = map(int, re.search(
        r"if \(roll && n > (\d+)\) return (\d+);", body).groups())
    steps = [(int(a), int(k)) for a, k in
             re.findall(r"n <= (\d+) \? (\d+) :", body)]
    last = int(re.search(r": (\d+);\s*$", body).group(1))
    launch_for = re.search(r"int launch_for\(const Launch& a\) \{(.*?)\n\}",
                           src, re.S).group(1)
    roll_branch = re.search(r"if constexpr \(kRoll\) \{(.*?)\} else",
                            launch_for, re.S).group(1)
    instances = {int(k): int(t) for k, t in re.findall(
        r"launch<(\d+), (\d+), kSpans, kRoll>", roll_branch)}
    instances.update({int(k): int(t) for k, t in re.findall(
        r"if \(kper == (\d+)\) return launch<\d+, (\d+), kSpans, kRoll>",
        launch_for)})
    for n, kper in K1_ROLL_KPER.items():
        got = roll_kper if n > above else next(
            (k for a, k in steps if n <= a), last)
        assert got == kper, (n, got)
        assert n // kper <= instances[kper] <= 256, (n, kper, instances)
    assert not os.path.exists(os.path.join(CSRC, "svol_filter.cu"))
    assert "ssme_svol_filter_sys" not in src
    names = _snake(_enum(src, "Span")[:-1], "k")
    assert tuple(_RENAME.get(n, n) for n in names) == sfk.SPAN_RECORD
    assert set(sfk.ROLL_BARRIERS_PER_STEP) == set(sfk.BARRIERS_PER_STEP)


def _k3_roll_bytes(kmodel, kper, threads):
    """Shared memory of a Liu-West roll instance's row, in bytes: the
    dynamic arrays (lw_megakernel_sys.cuh roll_row_bytes) and the static
    ones (partial buffers, the roll tail's list, the twin's record)."""
    p, k = kmodel.num_params, len(kmodel.functionals or ())
    slots = kper * threads
    dynamic = (4 * (slots + slots // 32 + (kmodel.num_state + p + 2 + k)
                    * slots) + 2 * slots)

    def wide(m):
        w = (m + 3) // 4
        return 4 * (w if w % 2 else w + 1)

    static = (4 * 32 + 4 * 32 * wide(1 + p)
              + 4 * 32 * max(wide(p * (p + 1) // 2), wide(k + 2))
              + 8 * (len(lwm.SPAN_RECORD) + 2) + 4 * 3
              + 4 * (1 + sel.ROLL_TAIL_THREADS * kper))
    return dynamic, static


def test_the_liu_west_kernels_roll_layout_and_instances():
    """roll_kper_for gives each N its kPer within kRollThreads, each roll
    kPer has its instance file and a case in the C entry's dispatch, the
    strided kernels are gone, a row at N = 4096 fits the card's 232,448
    bytes of shared memory a block, and the twins' record is the order
    SPAN_RECORD reads."""
    src = _source("lw_megakernel_sys.cuh")
    body = re.search(r"inline int roll_kper_for\(int n\) \{\s*return "
                     r"(.*?);", src, re.S).group(1)
    steps = [(int(a), int(k)) for a, k in
             re.findall(r"n <= (\d+) \? (\d+) :", body)]
    last = int(re.search(r": (\d+)$", body.strip()).group(1))
    threads = int(re.search(r"constexpr int kRollThreads = (\d+);",
                            src).group(1))
    entry = _source("lw_megakernel.cu")
    for n, kper in K3_ROLL_KPER.items():
        got = next((k for a, k in steps if n <= a), last)
        assert got == kper, (n, got)
        assert n // kper <= threads <= 512
        inst = _source(f"lw_megakernel_sys_roll{kper}.cu")
        assert (f"dispatch_layout<{kper}, kRollThreads, true>" in inst)
        assert f"case {kper}: return dispatch_roll{kper}(" in entry
    formula = re.sub(r"\s+", " ", re.search(
        r"constexpr int roll_row_bytes\(\) \{(.*?)\n\}", src,
        re.S).group(1))
    assert ("4 * (ssme::padded_size(kSlots) + (Model::kNumState + "
            "Model::kNumParams + 2 + Model::kNumFunctionals) * kSlots) + "
            "2 * kSlots") in formula
    for kmodel in (lwm.svol_leverage_lw_kernel_model(),
                   lwm.svol_t_lw_kernel_model(),
                   lwm.svol_leverage_lw_q_kernel_model()):
        dynamic, static = _k3_roll_bytes(kmodel, K3_ROLL_KPER[4096], threads)
        assert dynamic > 48 * 1024   # set with cudaFuncSetAttribute
        assert dynamic + static <= 232448, (kmodel.name, dynamic, static)
    for gone in ("lw_megakernel_roll.cu",):
        assert not os.path.exists(os.path.join(CSRC, gone))
    assert "__global__" not in entry
    names = _snake(_enum(src, "LWSpan")[:-1], "kLWSpan")
    assert tuple(_RENAME.get(n, n) for n in names) == lwm.SPAN_RECORD


def test_no_kernel_keeps_a_strided_helper():
    """The strided layout's helpers went with the last kernels that called
    them."""
    text = "".join(_source(f) for f in sorted(os.listdir(CSRC))
                   if f.endswith((".cu", ".cuh")))
    for name in ("StridedSlots", "void roll_ancestors(", "gather_leaves_per",
                 "systematic_ancestors_per", "StepRng", "block_sum"):
        assert name not in text, name
    assert not os.path.exists(os.path.join(CSRC, "systematic_select.cuh"))
