"""Plain models of the SVOL filter kernel's layout for Hopper
(``ssme_tpu_torch/csrc/svol_filter_sys.cu`` and ``csrc/row_select.cuh``):
kPer neighbouring particles per thread, one Philox call per pair, the CDF
built from a lane scan and serially chained warps, and the selection that
takes the place of a search: each particle counts its offspring, marks
its first slot, and each thread scans its slots' marks.

The models use the kernel's arithmetic in float32, so they pin down what
the kernel must compute; ``test_torch_kernels_cuda.py`` holds the kernel
itself to the plain filter on a card.  The selection is also held to JAX's
in-kernel selector (``select_leaves_dense``, interpret mode).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from ssme_tpu.ops._select import select_leaves_dense
from ssme_tpu_torch.ops import _prng, _select
from ssme_tpu_torch.ops._select import (_points, kernel_cdf,
                                        systematic_ancestors,
                                        systematic_ancestors_marks)

torch.set_num_threads(1)
KPERS = (2, 4, 8)
SIZES = (32, 96, 512, 4096)


def _paired_normals(seed, row, step, n, kper):
    """The kernel's draws for one row and step: thread i owns particles
    kper * i + p; its pair q is Philox counter ((kper / 2) i + q, step,
    row, 0), one call whose Box-Muller cosine goes to the even particle
    and sine to the odd.  Returns the (n,) normals and the counters each
    thread used."""
    k0, k1 = seed[0] & _prng.MASK32, seed[1] & _prng.MASK32
    z = torch.empty(n)
    used = []
    for i in range(n // kper):
        pairs = torch.arange(kper // 2) + (kper // 2) * i
        used.append(pairs.tolist())
        w0, w1, _, _ = _prng.philox4x32_10(
            pairs, torch.full_like(pairs, step), torch.full_like(pairs, row),
            torch.zeros_like(pairs), k0, k1)
        cos, sin = _prng.box_muller(w0, w1)
        z[kper * i:kper * (i + 1)] = torch.stack([cos, sin], dim=-1).reshape(
            -1)
    return z, used


@pytest.mark.parametrize("kper", KPERS)
def test_paired_draws_give_the_bits_of_normals_steps(kper):
    """One Philox call per pair, every pair once: the bits the plain
    filter draws (``normals_steps``) for every particle of a row."""
    seed = _prng.seed_words(0x9E3779B97F4A7C15)
    rows = torch.tensor([0, 5, 255])
    steps = torch.tensor([0, 1, 3083])
    for n in (96, 512):
        want = _prng.normals_steps(seed, rows, steps, n)
        for si, t in enumerate(steps.tolist()):
            for ri, b in enumerate(rows.tolist()):
                got, used = _paired_normals(seed, b, t, n, kper)
                assert torch.equal(got, want[si, ri])
                flat = [k for ks in used for k in ks]
                assert sorted(flat) == list(range(n // 2))


def _row_cdf(w, kper):
    """The kernel's CDF of one row (row_select.cuh warp_cdf and row_sums)
    in float32, through its plain model ``_select.kernel_cdf``: a serial
    prefix over each thread's kper weights, an inclusive lane scan of the
    thread totals, each lane's entries raised to the running max of the
    earlier lanes' last entries, and the warps' offsets chained serially.
    Returns (cdf (N,), the chained total)."""
    cdf, total = kernel_cdf(torch.from_numpy(np.asarray(w, np.float32))[None],
                            kper)
    return cdf[0].numpy(), np.float32(total[0])


def _weights(case, rows, n, rng):
    w = rng.gamma(1.0, 1.0, (rows, n)).astype(np.float32)
    if case == "dominant":
        w *= 1e-12
        w[np.arange(rows), rng.integers(0, n, rows)] = 1.0
    elif case == "zero_runs":
        for r in range(rows):
            for _ in range(3):
                a = rng.integers(0, n)
                w[r, a:a + rng.integers(n // 8, n // 2)] = 0.0
    return torch.from_numpy(w)


def _near_ulp_offsets(w, rng, skip_last=False):
    """Rows of ``w`` with offsets that put one point within one ulp of an
    entry of the row's CDF (with ``skip_last``, not its last entry)."""
    cdf = torch.cumsum(w, dim=-1)
    n = w.shape[1]
    rows, offs = [], []
    for r in range(w.shape[0]):
        k = int(rng.integers(n // 4, n - 1 if skip_last else n))
        step = (cdf[r, -1] / n).item()
        x = cdf[r, k].item() / step
        j = int(np.floor(x))
        base = np.float32(x - j)
        for d in range(-6, 7):
            u0 = base
            for _ in range(abs(d)):
                u0 = np.nextafter(u0, np.float32(2 if d > 0 else -1))
            if not 0.0 < u0 < 1.0:
                continue
            pt = _points(cdf[r:r + 1], torch.tensor([u0]))[0, j]
            gap = abs(float(pt) - float(cdf[r, k]))
            if gap <= float(np.spacing(np.float32(cdf[r, k]))):
                rows.append(r)
                offs.append(u0)
    return w[rows], torch.tensor(np.array(offs, np.float32))


@pytest.mark.parametrize("case", ["random", "dominant", "zero_runs",
                                  "one_ulp", "clamped"])
@pytest.mark.parametrize("n", SIZES)
def test_walk_equals_the_search(n, case):
    """The count-and-mark selection gives the binary search's ancestors
    on the same CDF and points, at every kPer, for random weights, one
    dominant weight, long zero runs, points within one ulp of a CDF entry
    and the last point clamped to the total."""
    rng = np.random.default_rng(n)
    rows = 16
    if case == "one_ulp":
        w, u0 = _near_ulp_offsets(_weights("random", rows, n, rng), rng)
        assert w.shape[0] >= rows
    elif case == "clamped":
        # the largest offset puts the last point on the total at a power
        # of two and past it in some rows at N=96, and trailing zeros make
        # the clamped point select the last particle of weight, not N - 1
        w = _weights("random", 64, n, rng)
        w[::2, -5:] = 0.0
        u0 = torch.full((64,), _prng.uniform_offset(
            torch.tensor(_prng.MASK32)).item())
        cdf = torch.cumsum(w, dim=-1)
        raw = (n - 1 + u0) * (cdf[:, -1] / n)
        if n & (n - 1):
            assert bool((raw > cdf[:, -1]).any())
        else:
            assert torch.equal(raw, cdf[:, -1])
    else:
        w = _weights(case, rows, n, rng)
        u0 = torch.from_numpy(rng.uniform(0.0, 1.0, rows).astype(np.float32))
    want = systematic_ancestors(w, u0)
    for kper in KPERS:
        got = systematic_ancestors_marks(torch.cumsum(w, dim=-1), u0,
                                         kper).ancestors
        assert torch.equal(got, want), kper
        if case == "dominant":
            assert bool((got == got[:, :1]).all())


# the count-and-mark selection's grid: every kPer its plain model takes,
# the kernels' sizes and the weights that stress a count
MARK_KPERS = (1, 2, 4, 8)
MARK_SIZES = (32, 96, 512, 1024, 4096)
MARK_CASES = ("random", "one_particle", "last_particle", "zero_runs",
              "one_ulp", "clamped")


def _mark_case(case, n, rng):
    """Weights (rows, n) and offsets (rows,) of one case: gamma weights;
    all the weight on one particle (the others exactly 0) or on the last;
    long zero runs; points within one ulp of a CDF entry, on gamma weights
    and on rows whose CDF entries in the second quarter lie one ulp apart;
    the largest offset, so the last points are clamped to the total."""
    rows = 16
    if case in ("random", "zero_runs"):
        w = _weights(case, rows, n, rng)
    elif case in ("one_particle", "last_particle"):
        w = torch.zeros((rows, n))
        at = (torch.full((rows,), n - 1) if case == "last_particle"
              else torch.from_numpy(rng.integers(0, n, rows)))
        w[torch.arange(rows), at] = 1.0
    elif case == "one_ulp":
        ulp = torch.ones((rows, n))
        ulp[:, n // 4:n // 2] = float(np.spacing(np.float32(n // 4)))
        pairs = [_near_ulp_offsets(v, rng, skip_last=True) for v in
                 (_weights("random", rows, n, rng), ulp)]
        assert all(len(u0) >= rows // 2 for _, u0 in pairs)
        return (torch.cat([w for w, _ in pairs]),
                torch.cat([u0 for _, u0 in pairs]))
    else:
        w = _weights("random", rows, n, rng)
        w[::2, -5:] = 0.0
        return w, torch.full((rows,), _prng.uniform_offset(
            torch.tensor(_prng.MASK32)).item())
    return w, torch.from_numpy(rng.uniform(0.0, 1.0, rows).astype(
        np.float32))


def _marks_mismatches(w, u0, kper):
    """Slots where the count-and-mark selection parts from the
    searchsorted law: on ``torch.cumsum``'s CDF against
    ``systematic_ancestors``, and on the kernels' CDF (``kernel_cdf``)
    against the search on it.  Returns (mismatches, the selections)."""
    on_cumsum = systematic_ancestors_marks(torch.cumsum(w, dim=-1), u0, kper)
    cdf, _ = kernel_cdf(w, kper)
    on_kernel = systematic_ancestors_marks(cdf, u0, kper)
    search = torch.clamp(torch.searchsorted(cdf, _points(cdf, u0),
                                            side="left"), max=w.shape[1] - 1)
    bad = int((on_cumsum.ancestors != systematic_ancestors(w, u0)).sum()
              + (on_kernel.ancestors != search).sum())
    return bad, (on_cumsum, on_kernel)


@pytest.mark.parametrize("case", MARK_CASES)
@pytest.mark.parametrize("n", MARK_SIZES)
@pytest.mark.parametrize("kper", MARK_KPERS)
def test_marks_selection_equals_the_searchsorted_law(kper, n, case):
    """Each particle's count of the points at or below its CDF entry, its
    marks and each thread's scan of its slots' marks give the searchsorted
    law's ancestors bit for bit, on the serial CDF and on the kernels';
    a particle writes at most 1 + N / (32 kPer) marks (its first slot and
    each warp's first slot inside its range), so a thread at most kPer +
    N / (32 kPer) - 1, and on a row whose weight sits on one particle one
    thread writes them all: one a warp, within 1 + N / (32 kPer)."""
    w, u0 = _mark_case(case, n, np.random.default_rng(7 * n + kper))
    bad, selections = _marks_mismatches(w, u0, kper)
    assert bad == 0
    warps = -(-n // (32 * kper))
    for sel in selections:
        assert int(sel.most_marks.max()) <= kper + warps - 1
        if case in ("one_particle", "last_particle"):
            assert bool((sel.most_marks == warps).all())
            assert int(sel.most_marks.max()) <= 1 + n / (32 * kper)
            assert bool((sel.ancestors == sel.ancestors[:, -1:]).all())


def test_marks_selection_needs_its_walk_to_the_count(monkeypatch):
    """Mutation probe: with each count left at its first guess (the walk
    to the exact count taken out of the plain model), the check above
    finds mismatches, and the guesses it keeps are the ones the model
    reports as fix-ups."""
    runs = [(_mark_case(case, n, np.random.default_rng(7 * n + kper)), kper)
            for case in ("random", "one_ulp") for n in (1024, 4096)
            for kper in (2, 8)]
    fixups = sum(int(sel.fixups.sum()) for (w, u0), kper in runs
                 for sel in _marks_mismatches(w, u0, kper)[1])
    assert fixups > 0
    assert sum(_marks_mismatches(w, u0, kper)[0]
               for (w, u0), kper in runs) == 0
    monkeypatch.setattr(_select, "_walk_counts", lambda cdf, c, at, n: c)
    assert sum(_marks_mismatches(w, u0, kper)[0]
               for (w, u0), kper in runs) > 0


@pytest.mark.parametrize("n", SIZES)
def test_kernel_cdf_never_falls_and_ends_at_its_total(n):
    """The kernel's CDF (lane scan, max of the earlier lanes, chained
    warps) never falls, its last entry is the chained total bit for bit,
    it agrees with the serial cumulative sum to float32 rounding, and the
    count-and-mark selection on it equals the search on it."""
    rng = np.random.default_rng(n + 1)
    for case in ("random", "zero_runs", "dominant"):
        w = _weights(case, 4, n, rng)
        u0 = torch.from_numpy(rng.uniform(0.0, 1.0, 4).astype(np.float32))
        for kper in KPERS:
            built = [_row_cdf(row.numpy(), kper) for row in w]
            cdf = torch.from_numpy(np.stack([c for c, _ in built]))
            assert bool((cdf[:, 1:] >= cdf[:, :-1]).all())
            assert [c[-1] for c, _ in built] == [t for _, t in built]
            serial = torch.cumsum(w.double(), -1).float()
            torch.testing.assert_close(cdf, serial, rtol=1e-5, atol=1e-6 * n)
            search = torch.clamp(torch.searchsorted(
                cdf, _points(cdf, u0), side="left"), max=n - 1)
            assert torch.equal(
                systematic_ancestors_marks(cdf, u0, kper).ancestors, search)


def _jax_ancestors(w, u0):
    """JAX's in-kernel systematic selector through a minimal
    interpret-mode ``pallas_call``: the ancestors as a moved id leaf."""
    n = w.shape[1]
    lt = np.tril(np.ones((n, n), np.float32)).T
    ids = np.tile(np.arange(n, dtype=np.float32), (w.shape[0], 1))

    def kernel(w_ref, u0_ref, lt_ref, ids_ref, out_ref):
        out_ref[:] = select_leaves_dense(w_ref[:], [ids_ref[:]], u0_ref[:],
                                         lt_ref[:])[0]

    out = pl.pallas_call(kernel, out_shape=jax.ShapeDtypeStruct(
        w.shape, jnp.float32), interpret=True)(
            jnp.asarray(w), jnp.asarray(u0[:, None]), jnp.asarray(lt),
            jnp.asarray(ids))
    return np.asarray(out).astype(np.int64)


@pytest.mark.parametrize("kper", KPERS)
def test_walk_matches_jax_away_from_boundaries(kper):
    """8 rows of N=256 gamma weights: the count-and-mark selection on the
    kernel's CDF model selects JAX's ancestors wherever a point lies
    farther than 2e-4 of the total from every CDF entry (float32 and
    JAX's bf16-compensated CDFs round otherwise)."""
    rng = np.random.default_rng(kper)
    w = rng.gamma(1.0, 1.0, (8, 256)).astype(np.float32)
    u0 = rng.uniform(0.05, 0.95, 8).astype(np.float32)
    want = _jax_ancestors(w, u0)
    cdf = torch.from_numpy(np.stack([_row_cdf(r, kper)[0] for r in w]))
    got = systematic_ancestors_marks(cdf, torch.from_numpy(u0),
                                     kper).ancestors.numpy()
    c64 = np.cumsum(w.astype(np.float64), axis=1)
    u = (np.arange(256)[None] + u0[:, None].astype(np.float64)) \
        * c64[:, -1:] / 256
    safe = np.min(np.abs(c64[:, None, :] - u[:, :, None]), axis=2) \
        > 2e-4 * c64[:, -1:]
    assert safe.sum() > 8 * 256 // 2
    np.testing.assert_array_equal(got[safe], want[safe])
