"""Plain models of the Liu-West kernel's systematic family for Hopper
(``ssme_tpu_torch/csrc/lw_megakernel_sys.cuh`` on ``csrc/row_select.cuh``):
paired draws for the P kernel draws and every functor's transition,
init and ``sample_q`` draws, the wide row sums (the moments' exchanges)
and the Cholesky every thread takes from them, the selection and gather of the
(2S + P)-leaf APF stage and the (S + P)-leaf joint resample through one
padded buffer per leaf, and the APF first stage's LSE from the scan total.

The models use the kernel's arithmetic in float32, so they pin down what
the kernel must compute; ``test_torch_kernels_cuda.py`` holds the kernel
itself to the plain version on a card.
"""

import numpy as np
import pytest
import torch

from ssme_tpu_torch.ops import _prng
from ssme_tpu_torch.ops import liu_west_megakernel as lwm
from ssme_tpu_torch.ops._select import kernel_cdf, systematic_ancestors_marks

torch.set_num_threads(1)
# the kPer the kernel's template takes; its instances run 2 at every N
KPERS = (2, 4)
FUNCTORS = {"svol_leverage_lw": lwm.svol_leverage_lw_kernel_model,
            "svol_t_lw": lwm.svol_t_lw_kernel_model,
            "svol_leverage_lw_q": lambda: lwm.svol_leverage_lw_q_kernel_model(
                1.5)}
SERIAL_WARPS = 8      # row_select.cuh kSerialWarps


class _PairRng:
    """``step_rng.cuh`` PairRng for the pairs ``q`` of a row at a step,
    from draw ``base``: draw base + k of the first particles is one Philox
    call on counter (q, t, b, tag of that draw) and one Box-Muller, whose
    cosine it returns and whose sine it keeps."""

    def __init__(self, seed, q, t, b, base):
        self._key = (seed[0] & _prng.MASK32, seed[1] & _prng.MASK32)
        self._q, self._t, self._b, self._base = q, t, b, base
        self.sine = []

    def normal(self, shape):
        q = self._q
        tag = _prng.normal_tag(self._base + len(self.sine))
        w0, w1, _, _ = _prng.philox4x32_10(
            q, torch.full_like(q, self._t), torch.full_like(q, self._b),
            torch.full_like(q, tag), *self._key)
        cos, sin = _prng.box_muller(w0, w1)
        self.sine.append(sin.reshape(shape))
        return cos.reshape(shape)


class _PairSines:
    """``step_rng.cuh`` PairSines: the second particles' draws, the sines
    the first particles' draws kept, in their order."""

    def __init__(self, first):
        self._sine, self._draw = first.sine, 0

    def normal(self, shape):
        self._draw += 1
        return self._sine[self._draw - 1]


def _pairs(n, kper):
    """The pair indices thread by thread (thread i owns particles
    kper * i + p, so pairs (kper / 2) i + qq), and the particle each
    pair's first and second draw go to."""
    q = torch.arange(n // 2)
    i, qq = q // (kper // 2), q % (kper // 2)
    return q, kper * i + 2 * qq, kper * i + 2 * qq + 1


def _take(tree, idx):
    return tuple(v[..., idx] for v in tree)


@pytest.mark.parametrize("kper", KPERS)
@pytest.mark.parametrize("name", sorted(FUNCTORS))
def test_pair_rng_gives_the_bits_of_normal_at(name, kper):
    """Every draw of a step through the pair rng: the P kernel draws (one
    call per pair and draw k, cosine to particle 2q, sine to 2q + 1) are
    ``normals_steps(..., draw=k)``'s, and the functor's init, transition
    and (the q instance) sample_q hooks fed the pairs from draw P on move
    every particle exactly as the plain version's rng makes them."""
    km = FUNCTORS[name]()
    p = km.num_params
    seed = _prng.seed_words(0x5DEECE66D)
    n, b, t_len = 64, 5, 64
    q, even, odd = _pairs(n, kper)
    assert sorted(torch.cat([even, odd]).tolist()) == list(range(n))
    rows = torch.tensor([b])
    plain = lwm._PlainRng(seed, rows, n, t_len, p)
    gen = torch.Generator().manual_seed(7)
    cp = km.sample_prior(plain.at(0), (1, n))
    x = (torch.randn(1, n, generator=gen),)
    y = (torch.tensor(0.8),)
    z = (torch.tensor(-0.3),) if km.dim_cov else ()
    for t in (0, 1, 63):
        first = _PairRng(seed, q, t, b, 0)
        for k in range(p):
            cos = first.normal((n // 2,))
            want = plain.normals(t, k)[0]
            assert torch.equal(cos, want[even])
            assert torch.equal(first.sine[k], want[odd])
        hooks = [("init", lambda rng, c, s: km.init(rng, c, y, s[0].shape))]
        if t:
            hooks.append(("propagate",
                          lambda rng, c, s: km.propagate(rng, c, s, y, z)))
            if km.sample_q is not None:
                hooks.append(("sample_q",
                              lambda rng, c, s: km.sample_q(rng, c, s, y, z)))
        for what, hook in hooks:
            first = _PairRng(seed, q, t, b, p)
            got_even = hook(first, cp[..., even], _take(x, even))
            got_odd = hook(_PairSines(first), cp[..., odd], _take(x, odd))
            want = hook(plain.at(t), cp, x)
            for leaf, (a, c) in enumerate(zip(got_even, got_odd)):
                assert torch.equal(a, want[leaf][..., even]), (what, leaf)
                assert torch.equal(c, want[leaf][..., odd]), (what, leaf)


def _warp_sum(v):
    """row_select.cuh warp_sum on (..., 32) lanes: the xor
    butterfly, every lane's result."""
    lanes = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        v = v + v[..., lanes ^ o]
    return v


def _row_sums_wide(terms, kper):
    """row_select.cuh row_sums_wide on (B, N, K) per-particle terms: each
    thread folds its kper terms serially from 0, the warps reduce with the
    butterfly, and every thread reads the warps' partials (serially up to
    SERIAL_WARPS warps, else one per lane and the butterfly).  Returns the
    sums every thread holds, (B, threads, K), float32."""
    b, n, k = terms.shape
    used = n // kper
    threads = -(-used // 32) * 32
    per = torch.zeros((b, threads, kper, k), dtype=torch.float32)
    per[:, :used] = terms.to(torch.float32).reshape(b, used, kper, k)
    fold = torch.zeros((b, threads, k), dtype=torch.float32)
    for p in range(kper):
        fold = fold + per[:, :, p]
    warps = threads // 32
    lanes = _warp_sum(fold.reshape(b, warps, 32, k).transpose(-1, -2))
    assert bool((lanes == lanes[..., :1]).all())     # every lane, same bits
    part = lanes[..., 0]                              # (B, warps, K)
    if warps > SERIAL_WARPS:
        pad = torch.zeros((b, 32, k), dtype=torch.float32)
        pad[:, :warps] = part
        got = _warp_sum(pad.transpose(-1, -2))[..., 0]
    else:
        got = torch.zeros((b, k), dtype=torch.float32)
        for u in range(warps):
            got = got + part[:, u]
    return got[:, None, :].expand(b, threads, k)


def _moment_terms(w, th):
    """The kernel's per-particle terms of the moments' two exchanges: (w,
    theta_k w) and, centred on the first's theta_bar, the packed Gram
    (cen_r w) cen_c, r >= c; returns both sums and wsum."""
    p = th.shape[1]
    s1 = _row_sums_wide(torch.cat([w[..., None], (th * w[:, None])
                                   .transpose(1, 2)], dim=-1), KPERS[0])[:, 0]
    wsum = s1[:, :1]
    tbar = s1[:, 1:] / wsum                            # (B, P)
    cen = th - tbar[..., None]                         # (B, P, N)
    gram = [(cen[:, r] * w) * cen[:, c] for r in range(p)
            for c in range(r + 1)]
    s2 = _row_sums_wide(torch.stack(gram, dim=-1), KPERS[0])[:, 0]
    return s1, s2, wsum


@pytest.mark.parametrize("kper", KPERS)
@pytest.mark.parametrize("n", [32, 96, 256])
def test_wide_row_sums_give_every_thread_the_same_bits(n, kper):
    """The moments' exchanges (1 + P sums, then the P(P+1)/2 Gram sums at
    P = 4; the weights' K + 2): every simulated thread holds the same
    bits, within 1e-6 relative of ``torch.sum``."""
    rng = np.random.default_rng(n * 10 + kper)
    for k in (5, 10, 3):
        terms = torch.from_numpy(rng.gamma(2.0, 1.0, (8, n, k))
                                 .astype(np.float32))
        sums = _row_sums_wide(terms, kper)
        assert bool((sums == sums[:, :1]).all())
        torch.testing.assert_close(sums[:, 0].double(),
                                   terms.double().sum(1), rtol=1e-6, atol=0)


def _thread_cholesky(s2, wsum, h2, p):
    """The Cholesky every thread computes (lw_megakernel_sys.cuh): from the
    packed Gram sums s2[r (r + 1) / 2 + c] and wsum, in float32, with one
    divide for h^2 / wsum, a reciprocal per column and fused
    multiply-subtracts, the floored diagonal."""
    h2w = torch.tensor(h2, dtype=torch.float32) / wsum[:, 0]
    chol = [[None] * p for _ in range(p)]
    for jj in range(p):
        acc = h2w * s2[:, jj * (jj + 1) // 2 + jj]
        for k in range(jj):
            acc = _fma(-chol[jj][k], chol[jj][k], acc)
        chol[jj][jj] = torch.sqrt(torch.where(acc < 1e-9, 1e-9, acc))
        inv_d = 1.0 / chol[jj][jj]
        for r in range(jj + 1, p):
            acc2 = h2w * s2[:, r * (r + 1) // 2 + jj]
            for k in range(jj):
                acc2 = _fma(-chol[r][k], chol[jj][k], acc2)
            chol[r][jj] = acc2 * inv_d
    return chol


def _fma(a, b, c):
    """a * b + c rounded once to float32 (the product of two float32 values
    is exact in float64)."""
    return (a.double() * b.double() + c.double()).float()


@pytest.mark.parametrize("case", ["spd", "floored"])
@pytest.mark.parametrize("p", [3, 4])
def test_thread_cholesky_from_the_gram_sums(p, case):
    """The per-thread factor of h^2 Vt from the wide sums (reciprocals in
    place of the plain version's divides) equals ``_cholesky`` of the same
    Gram to 1e-6 and numpy's float64 Cholesky of
    h^2 Vt to 1e-5; with one parameter constant over the cloud its
    diagonal is floored at 1e-9 (the factor of h^2 Vt with that diagonal
    entry set to 1e-9)."""
    rng = np.random.default_rng(p + 10 * (case == "floored"))
    n, rows = 256, 4
    mix = np.eye(p) + 0.5 * rng.normal(size=(p, p))   # correlated theta
    th = torch.from_numpy((np.einsum("ij,rjn->rin", mix,
                                     rng.normal(size=(rows, p, n)))
                           + rng.normal(size=(rows, p, 1))).astype(np.float32))
    if case == "floored":
        th[:, 0] = 0.5      # sum 0.5 w / sum w is 0.5 exactly: cen = 0
    w = torch.from_numpy(rng.gamma(1.0, 1.0, (rows, n)).astype(np.float32))
    _, s2, wsum = _moment_terms(w, th)
    a, _, h2 = lwm._coefficients(0.98)
    got = _thread_cholesky(s2, wsum, h2, p)
    gram = [[(s2[:, r * (r + 1) // 2 + c] / wsum[:, 0])[:, None]
             if c <= r else None for c in range(p)] for r in range(p)]
    want = lwm._cholesky(gram, h2, p)
    for r in range(p):
        for c in range(r + 1):
            torch.testing.assert_close(got[r][c], want[r][c][:, 0], rtol=0,
                                       atol=1e-6)
    th64, w64 = th.double().numpy(), w.double().numpy()
    for row in range(rows):
        ww = w64[row] / w64[row].sum()
        tb = th64[row] @ ww
        cen = th64[row] - tb[:, None]
        vt = h2 * (cen * ww) @ cen.T
        if case == "floored":
            vt[0, 0] = 1e-9
        ref = np.linalg.cholesky(vt)
        fac = np.array([[float(got[r][c][row]) if c <= r else 0.0
                         for c in range(p)] for r in range(p)])
        np.testing.assert_allclose(fac, ref, rtol=1e-5, atol=1e-7)
        if case == "floored":
            assert fac[0, 0] == pytest.approx(np.sqrt(1e-9), rel=1e-6)
            assert not fac[1:, 0].any()


def _padded(j):
    """row_select.cuh padded: one pad word after every 32 entries."""
    return j + j // 32


@pytest.mark.parametrize("kper", KPERS)
@pytest.mark.parametrize("n", [32, 96, 256])
@pytest.mark.parametrize("what", ["apf_stage", "joint_resample"])
def test_leaf_walk_and_gather_move_every_leaf_by_one_ancestry(what, n, kper):
    """The APF stage's 2S + P leaves (state, lookahead, shrunk theta: 6 for
    the leverage model) and the joint resample's S + P (state, theta: 5),
    each staged in its own padded shared array (leaf l at l * stride),
    the count-and-mark selection on the CDF, and every leaf gathered by
    the same ancestors, which are the binary search's on the kernel's CDF
    (which never falls)."""
    rng = np.random.default_rng(n + 7 * kper + (what == "apf_stage"))
    rows, num_leaves = 8, 6 if what == "apf_stage" else 5
    u0 = torch.from_numpy(rng.uniform(0.0, 1.0, rows).astype(np.float32))
    leaves = torch.cat([
        torch.arange(n, dtype=torch.float32).expand(1, rows, n),
        torch.from_numpy(rng.normal(size=(num_leaves - 1, rows, n))
                         .astype(np.float32))])
    w = torch.from_numpy(rng.gamma(1.0, 1.0, (rows, n)).astype(np.float32))
    w[:2, n // 4:n // 2] = 0.0
    cdf, total = kernel_cdf(w, kper)
    assert torch.equal(cdf[:, -1], total)
    assert bool((cdf[:, 1:] >= cdf[:, :-1]).all())
    stride = _padded(n)
    buf = torch.full((rows, num_leaves * stride), float("nan"))
    at = _padded(torch.arange(n))
    for leaf in range(num_leaves):
        buf[:, leaf * stride + at] = leaves[leaf]
    anc = systematic_ancestors_marks(cdf, u0, kper).ancestors
    moved = torch.stack([torch.gather(buf, 1, leaf * stride + _padded(anc))
                         for leaf in range(num_leaves)])
    u = torch.minimum((torch.arange(n)[None] + u0[:, None])
                      * (total[:, None] / n), total[:, None])
    search = torch.clamp(torch.searchsorted(cdf, u, side="left"), max=n - 1)
    assert torch.equal(anc, search)
    assert torch.equal(moved[0], anc.to(torch.float32))
    for leaf in range(1, num_leaves):
        assert torch.equal(moved[leaf], torch.gather(leaves[leaf], 1, anc))


# the APF first stage's LSE from the scan total against logsumexp: the
# kernel's float32 sum (kper serial adds, a 5-level lane scan, the warps
# chained) is within a few ulp of the total, so within 1e-5 nats
LSE_TOL = 1e-5


@pytest.mark.parametrize("kper", KPERS)
@pytest.mark.parametrize("n", [32, 96, 256])
def test_apf_first_stage_lse_from_the_scan_total(n, kper):
    """The first stage's exchange carries only the warps' CDF totals
    (the largest of the active lanes' last entries) and chains them
    serially;
    that total is ``kernel_cdf``'s last entry bit for bit, and max +
    log(total) is LSE(fsw) within LSE_TOL."""
    rng = np.random.default_rng(5 * n + kper)
    fsw = torch.from_numpy((rng.normal(size=(8, n)) * 4.0 - 30.0)
                           .astype(np.float32))
    fsw[0, : n // 2] = -1e30        # negligible particles
    m = torch.amax(fsw, dim=-1, keepdim=True)
    w = torch.exp(fsw - m)
    used = n // kper
    threads = -(-used // 32) * 32
    per = torch.zeros((8, threads, kper))
    per[:, :used] = w.reshape(8, used, kper)
    for p in range(1, kper):
        per[..., p] = per[..., p - 1] + per[..., p]
    lanes = per[..., -1].reshape(8, threads // 32, 32)
    for o in (1, 2, 4, 8, 16):          # the lane scan (shuffle up)
        lanes = torch.cat([lanes[..., :o], lanes[..., o:] + lanes[..., :-o]],
                          dim=-1)
    excl = torch.cat([torch.zeros((8, threads // 32, 1)), lanes[..., :-1]],
                     dim=-1)
    last = excl + per[..., -1].reshape(8, threads // 32, 32)
    active = (torch.arange(threads) < used).reshape(threads // 32, 32)
    warp_last = torch.amax(torch.where(active, last, 0.0), dim=-1)
    total = torch.zeros(8)
    for u in range(threads // 32):
        total = total + warp_last[:, u]
    cdf, cdf_total = kernel_cdf(w, kper)
    assert torch.equal(total, cdf_total) and torch.equal(total, cdf[:, -1])
    lse = m[:, 0] + torch.log(total)
    torch.testing.assert_close(lse, torch.logsumexp(fsw, dim=-1), rtol=0,
                               atol=LSE_TOL)
    torch.testing.assert_close(
        lse.double(), torch.logsumexp(fsw.double(), dim=-1), rtol=0,
        atol=LSE_TOL)
