"""The tensor-core kernels' numerics and SchNet's symmetric route, on the
CPU.

``ops/csrc/cfconv_bwd.cu`` runs its six tile products (``painn_bwd.cu`` its
three, ``schnet_stack.cu`` and ``painn_stack.cu`` their filter and dense
products, ``cfconv_fwd.cu`` its two filter products, ``ncsn_score.cu``'s
backward its three head products) with
``mma.sync.m16n8k8`` in 3xTF32 (``csrc/mma_tf32.cuh``): each f32 operand is
split into a TF32 high part (its top 19 bits) and the f32 remainder, whose
top 19 bits the tensor core reads, and the product is
summed as lo*hi + hi*lo + hi*hi in f32, one k-block of 8 at a time. The
emulation below does the same in PyTorch at the kernel's tile shapes, and
shows why one TF32 pass would not do: it misses ``chip_smoke.py``'s
tolerance on a ddist-like row sum that the three passes meet. ``mma_chain``
also emulates the tensor core's truncating accumulator, which is what the
precise mode is for: a sum over every tile of a run (the NCSN backward's
dW2) drifts in the plain split and stays within f32 rounding in the precise
mode, while the symmetric CFConv forward's two chained products meet their
tolerance in the plain split; so does the PaiNN stack's chain of 18 dense
products in the precise mode, and not in the plain split.
"""

import numpy as np
import pytest
import torch

from geossl_tpu_torch.ops import cfconv as tcf
from geossl_tpu_torch.ops import painn as tpn

# Six test workers share the machine's cores: one intra-op thread each
# (torch's default, one per core, makes these small ops 10-50x slower
# under that load); the ranks these tests start take the same.
torch.set_num_threads(1)

# chip_smoke.py's elementwise tolerance for ddist/denv/dx
RTOL, ATOL = 1e-4, 1e-5


def _bits(x):
    return x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def _float(b):
    b = torch.where(b >= 2**31, b - 2**32, b)
    return b.to(torch.int32).view(torch.float32)


def tf32_trunc(x):
    """The top 19 bits of x (TF32: 10 mantissa bits), as the kernel's
    split_tf32 takes the high part and as the tensor core reads an
    operand."""
    return _float(_bits(x) & 0xFFFFE000)


def tf32_round(x):
    """x rounded to TF32, to nearest with ties away from zero (what
    cvt.rna.tf32.f32 gives): the single-pass comparison."""
    return _float((_bits(x) + 0x1000) & 0xFFFFE000)


def mma_product(a, b, passes, split=None):
    """a [M,K] @ b [K,N] in f32 as mma.m16n8k8 computes it: per k-block of
    8 each pass's products summed exactly, the f32 accumulator rounded after
    every pass. passes=3 is the kernels' 3xTF32, passes=1 one TF32 pass.
    ``split=tf32_round`` is the precise mode's split (``split_tf32<true>``:
    both parts rounded to nearest); the default cuts both, as the CFConv
    and PaiNN backward kernels do."""
    a, b = a.float(), b.float()
    cut = split or tf32_trunc
    if passes == 1:
        terms = [(tf32_round(a), tf32_round(b))]
    else:
        ah, bh = cut(a), cut(b)
        terms = [(cut(a - ah), bh), (ah, cut(b - bh)), (ah, bh)]
    c = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float32)
    for k0 in range(0, a.shape[1], 8):
        ks = slice(k0, k0 + 8)
        for x, y in terms:
            c = (c.double() + x[:, ks].double() @ y[ks].double()).float()
    return c


def _operands(rng, m, k, n, kind):
    """DDM-like operands at a tile shape: the RBF against W1, the hidden
    layer against W2, and s^T against qe (the dW2 product)."""
    if kind == "rbf_w1":  # G = 51 padded to K = 56 with zeros
        d = rng.uniform(0.8, 10.0, (m, 1))
        a = np.zeros((m, k))
        a[:, :51] = np.exp(-0.5 / 0.2**2 * (d - np.linspace(0.0, 10.0, 51)) ** 2)
        b = rng.normal(0.0, 1.0 / np.sqrt(51), (k, n))
        b[51:] = 0.0
    elif kind == "s_w2":
        pre = rng.normal(0.0, 1.5, (m, k))
        a = np.logaddexp(pre, 0.0) - np.log(2.0)
        b = rng.normal(0.0, 1.0 / np.sqrt(k), (k, n))
    elif kind == "sT_qe":  # K runs over the tile's 64 pairs
        pre = rng.normal(0.0, 1.5, (k, m))
        a = (np.logaddexp(pre, 0.0) - np.log(2.0)).T
        env = rng.uniform(0.0, 1.0, (k, 1))
        b = env * rng.normal(0.0, 1.0, (k, n)) * rng.normal(0.0, 1.0, (k, n))
    elif kind in ("phi_wk", "phiT_dwg", "dwg_wkT"):
        # painn_bwd's plain mode: [phi; 1] (R = 20 RBF rows, the bias row,
        # zeros to 24 or 32), [Wk; bk] and the gated filter cotangent dwg
        r = 20
        delta = 5.0 / (r - 1)
        phi = np.zeros((64, 32))
        d = rng.uniform(0.5, 5.0, (64, 1))
        phi[:, :r] = np.exp(-0.5 / delta**2 * (d - delta * np.arange(r)) ** 2)
        phi[:, r] = 1.0
        wk = np.zeros((32, 384))
        wk[:r] = rng.normal(0.0, 1.0 / np.sqrt(r), (r, 384))
        wk[r] = rng.normal(0.0, 0.1, 384)
        dwg = (rng.uniform(0.0, 1.0, (64, 1)) * rng.normal(0.0, 1.0, (64, 384))
               * rng.normal(0.0, 1.0, (64, 384)))
        a, b = {"phi_wk": (phi[:, :k], wk[:k]),
                "phiT_dwg": (phi.T[:m], dwg),
                "dwg_wkT": (dwg, wk.T[:, :n])}[kind]
    elif kind in ("l1_w2", "dx2_w2t"):
        # ncsn_score.cu's backward: l1 = relu(.) [64 pairs x E=128] against
        # W2 [E x H=64], and dx2 = relu'(pre2) ds w3 [64 x H] against W2^T
        w2 = rng.normal(0.0, 1.0 / np.sqrt(128), (128, 64))
        if kind == "l1_w2":
            a, b = np.maximum(rng.normal(0.2, 1.0, (m, k)), 0.0), w2
        else:
            ds = rng.normal(0.0, 1.0, (m, 1))
            a = np.where(rng.normal(0.0, 1.0, (m, k)) > 0, ds * rng.normal(0.0, 0.2, (1, k)), 0.0)
            b = w2.T
    else:  # "dense": schnet_stack's h Wl1, m Wa, ssp(.) Wb over 64 atom rows
        a = rng.normal(0.0, 1.0, (m, k))
        b = rng.normal(0.0, 1.0 / np.sqrt(k), (k, n))
    return (torch.from_numpy(a.astype(np.float32)),
            torch.from_numpy(b.astype(np.float32)))


@pytest.mark.parametrize("m,k,n,kind", [(64, 56, 128, "rbf_w1"),
                                        (64, 128, 128, "s_w2"),
                                        (128, 64, 128, "sT_qe"),
                                        (64, 24, 384, "phi_wk"),
                                        (32, 64, 384, "phiT_dwg"),
                                        (64, 384, 32, "dwg_wkT"),
                                        (64, 128, 128, "dense"),
                                        (64, 128, 64, "l1_w2"),
                                        (64, 64, 128, "dx2_w2t")])
def test_3xtf32_product_within_2e6_of_f64(m, k, n, kind):
    a, b = _operands(np.random.default_rng(m + k + n), m, k, n, kind)
    want = a.double() @ b.double()
    got = mma_product(a, b, passes=3)
    rel = ((got.double() - want).norm() / want.norm()).item()
    assert rel < 2e-6, rel
    one = ((mma_product(a, b, passes=1).double() - want).norm()
           / want.norm()).item()
    assert one > 50 * rel  # the two small terms carry the f32 accuracy


@pytest.mark.parametrize("m,k,n,kind", [(64, 56, 128, "rbf_w1"),
                                        (64, 128, 128, "s_w2"),
                                        (64, 128, 128, "dense"),
                                        (64, 128, 64, "l1_w2")])
def test_rounded_split_is_closer_to_f64(m, k, n, kind):
    """The precise mode (schnet_stack, the NCSN backward's l1 W2) rounds
    both TF32 parts: at these tile shapes that is within 6e-7 of the f64
    product, closer than the cut split (the rest of the mode, f32
    accumulation of each k step, is what the emulation already does)."""
    a, b = _operands(np.random.default_rng(3 * m + k + n), m, k, n, kind)
    want = a.double() @ b.double()

    def rel(got):
        return ((got.double() - want).norm() / want.norm()).item()

    rounded = rel(mma_product(a, b, 3, split=tf32_round))
    assert rounded < 6e-7, rounded
    assert rounded < rel(mma_product(a, b, 3))


def trunc_f32(x):
    """An f64 value to f32, rounded toward zero: how the tensor core adds a
    product to its f32 accumulator."""
    f = x.float()
    over = f.double().abs() > x.abs()
    return torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f)


def mma_chain(pairs, precise, tile_sums=False, round_b=False):
    """sum_t A_t @ B_t as ``warp_tile_mma`` chains it over a run of tiles
    into one accumulator: 3xTF32 per k-block of 8, each pass added to the
    accumulator with truncation; with ``precise`` both parts rounded
    (``split_tf32<true>``) and each k step's three passes summed apart (with
    truncation) and then added to the accumulator in f32, to nearest. With
    ``tile_sums`` each tile's product goes into a zeroed accumulator that is
    then added to the run's sum in f32 (the NCSN backward's dW2). With
    ``round_b`` B's parts are rounded whatever the mode: B split once per
    block (``split_b``, the kBLo operand of the PaiNN and NCSN forwards)."""
    cut = tf32_round if precise else tf32_trunc
    cut_b = tf32_round if round_b else cut
    c = None
    for a, b in pairs:
        a, b = a.float(), b.float()
        ah, bh = cut(a), cut_b(b)
        terms = [(cut(a - ah), bh), (ah, cut_b(b - bh)), (ah, bh)]
        if c is None:
            c = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float32)
        if tile_sums:
            c = (c.double() + mma_chain([(a, b)], precise, round_b=round_b).double()).float()
            continue
        for k0 in range(0, a.shape[1], 8):
            ks = slice(k0, k0 + 8)
            if precise:
                d = torch.zeros_like(c)
                for x, y in terms:
                    d = trunc_f32(d.double() + x[:, ks].double() @ y[ks].double())
                c = (c.double() + d.double()).float()
            else:
                for x, y in terms:
                    c = trunc_f32(c.double() + x[:, ks].double() @ y[ks].double())
    return c


@pytest.mark.parametrize("tiles", [16, 64])
def test_precise_mode_keeps_a_run_sum_of_dw2_at_f32(tiles):
    """The NCSN backward sums dW2 += l1^T dx2 over every tile of a block's
    run: in one accumulator the plain split's truncation drifts with the
    number of tiles; the precise mode, and the kernel's sums of each tile's
    product added in f32, stay within f32 rounding."""
    rng = np.random.default_rng(tiles)
    pairs = []
    for _ in range(tiles):
        l1t, _ = _operands(rng, 64, 128, 64, "l1_w2")
        dx2, _ = _operands(rng, 64, 64, 128, "dx2_w2t")
        pairs.append((l1t.T.contiguous(), dx2))
    want = sum(a.double() @ b.double() for a, b in pairs)

    def rel(got):
        return ((got.double() - want).norm() / want.norm()).item()

    precise, plain = rel(mma_chain(pairs, True)), rel(mma_chain(pairs, False))
    assert precise < 1e-6, precise
    assert plain > 10 * precise
    # what the kernel does: each tile's product (plain split, K = 64 pairs)
    # added to the run's sum in f32
    tiles_f32 = rel(mma_chain(pairs, False, tile_sums=True))
    assert tiles_f32 < 1e-6 and plain > 10 * tiles_f32, tiles_f32


@pytest.mark.parametrize("seed", [0, 1])
def test_forward_filter_products_meet_the_tolerance_in_the_plain_split(seed):
    """cfconv_fwd.cu's symmetric mode chains rbf[64 x G->56] W1, ssp and
    W2 in the plain split and sums the messages of 13 tiles of a row: within
    chip_smoke.py's rtol 1e-4 / atol 1e-5 of the f64 message at under half
    the tolerance (the precise mode buys nothing it needs)."""
    rng = np.random.default_rng(seed)
    g_n, f, tiles = 51, 128, 13
    delta = 10.0 / (g_n - 1)
    off = np.linspace(0.0, 10.0, g_n)
    w1 = np.zeros((56, f))
    w1[:g_n] = rng.normal(0.0, 1.0 / np.sqrt(g_n), (g_n, f))
    b1, b2 = rng.normal(0.0, 0.1, f), rng.normal(0.0, 0.1, f)
    w2 = rng.normal(0.0, 1.0 / np.sqrt(f), (f, f))

    def f32(a):
        return torch.from_numpy(np.asarray(a, dtype=np.float32))

    want, got = np.zeros((8, f)), torch.zeros(8, f, dtype=torch.float32)
    for _ in range(tiles):
        d = rng.uniform(0.8, 10.0, (8, 8))
        env, x = rng.uniform(0.0, 1.0, (8, 8)), rng.normal(0.0, 1.0, (8, f))
        rbf = np.zeros((64, 56))
        rbf[:, :g_n] = np.exp(-0.5 / delta**2 * (d.reshape(64, 1) - off) ** 2)
        w = (np.logaddexp(rbf @ w1 + b1, 0.0) - np.log(2.0)) @ w2 + b2
        want += np.einsum("ij,ijf,jf->if", env, w.reshape(8, 8, f), x)
        h = mma_chain([(f32(rbf), f32(w1))], False) + f32(b1)
        s = torch.logaddexp(h, torch.zeros_like(h)) - np.log(2.0)
        wk = mma_chain([(s, f32(w2))], False) + f32(b2)
        got += torch.einsum("ij,ijf,jf->if", f32(env), wk.view(8, 8, f), f32(x))
    want = torch.from_numpy(want)
    ratio = ((got.double() - want).abs() / (ATOL + RTOL * want.abs())).max().item()
    assert ratio < 0.5, ratio


def _f32(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float32))


@pytest.mark.parametrize("seed", [0, 1])
def test_painn_filter_in_the_plain_split_meets_the_forward_tolerance(seed):
    """painn_fwd.cu's plain mode computes each tile's gated filter [phi; 1]
    gate [Wk; bk] (64 x 24 . 24 x 384: R = 20 RBF rows, the bias row, zeros;
    the gate folded into the A rows) in the plain split, [Wk; bk] split into
    its rounded TF32 parts once per block, and sums the messages of a row's
    12 tiles into dq and the three dmu channels in f32: within half of
    chip_smoke.py's rtol 1e-4 / atol 1e-5 of the f64 messages."""
    rng = np.random.default_rng(seed)
    r, f, tiles, cutoff = 20, 128, 12, 5.0
    delta = cutoff / (r - 1)
    wk = np.zeros((24, 3 * f))
    wk[:r] = rng.normal(0.0, 1.0 / np.sqrt(r), (r, 3 * f))
    wk[r] = rng.uniform(-1.0, 1.0, 3 * f) / np.sqrt(r)
    want, got = np.zeros((8, 4 * f)), torch.zeros(8, 4 * f, dtype=torch.float32)
    for _ in range(tiles):
        # pair p = jl*8 + il is row p; ~40% of the pairs within the cutoff
        d = rng.uniform(0.8, 8.0, (8, 8))  # [jl, il]
        gate = np.where(d < cutoff, 0.5 * (np.cos(np.pi * d / cutoff) + 1.0), 0.0)
        dirs = rng.normal(size=(3, 8, 8))
        dirs /= np.linalg.norm(dirs, axis=0)
        x, mu = rng.normal(0.0, 1.0, (8, 3 * f)), rng.normal(0.0, 1.0, (8, 3 * f))
        phi = np.zeros((64, 24))
        phi[:, :r] = np.exp(-0.5 / delta**2 * (d.reshape(64, 1) - delta * np.arange(r)) ** 2)
        phi[:, r] = 1.0
        # gate, dirs, x and mu in f32 for both sides: the kernel's inputs
        gate, dirs, x, mu = (np.asarray(_f32(a), dtype=np.float64) for a in (gate, dirs, x, mu))
        w = (phi @ wk).reshape(8, 8, 3 * f) * gate[..., None]  # [jl, il, 3f]
        want[:, :f] += np.einsum("jif,jf->if", w[..., :f], x[:, :f])
        for c in range(3):
            want[:, f * (c + 1):f * (c + 2)] += (
                np.einsum("jif,jf,ji->if", w[..., f:2 * f], x[:, f:2 * f], dirs[c])
                + np.einsum("jif,jf,jf->if", w[..., 2 * f:], x[:, 2 * f:], mu[:, c * f:(c + 1) * f]))
        a = _f32(phi) * _f32(gate).reshape(64, 1)  # the A rows, gated in f32
        wg = mma_chain([(a, _f32(wk))], False, round_b=True).view(8, 8, 3 * f)
        wx = wg * _f32(x)[:, None, :]  # w x, [jl, il, 3f]
        got[:, :f] += wx[..., :f].sum(0)
        for c in range(3):
            got[:, f * (c + 1):f * (c + 2)] += (
                (wx[..., f:2 * f] * _f32(dirs[c])[..., None]).sum(0)
                + (wx[..., 2 * f:] * _f32(mu[:, c * f:(c + 1) * f])[:, None, :]).sum(0))
    want = torch.from_numpy(want)
    ratio = ((got.double() - want).abs() / (ATOL + RTOL * want.abs())).max().item()
    assert ratio < 0.5, ratio


def _ncsn_rows(sigma, precise, seed=0, tiles=12):
    """Loss rows of 8 rows i over ``tiles`` tiles of 8 pairs j each, as
    ncsn_score.cu's forward computes them (pre2 = l1 W2 per tile in 3xTF32,
    W2 split once per block; the rest in f32), and in f64; anneal 2."""
    rng = np.random.default_rng(seed)
    e, h = 128, 64
    w2 = rng.normal(0.0, 1.0 / np.sqrt(e), (e, h))
    b2, w3 = rng.normal(0.0, 0.1, h), rng.normal(0.0, 1.0 / np.sqrt(h), h)
    b3 = 0.1
    want, got = np.zeros(8), torch.zeros(8, dtype=torch.float32)
    sig = torch.tensor(sigma, dtype=torch.float32)
    for _ in range(tiles):
        l1 = np.asarray(_f32(np.maximum(rng.normal(0.2, 1.0, (64, e)), 0.0)), np.float64)
        noise = np.asarray(_f32(rng.normal(size=64)), np.float64)
        score = (np.maximum(l1 @ w2 + b2, 0.0) @ w3 + b3) / sigma
        want += (0.5 * (score + noise / sigma) ** 2 * sigma**2).reshape(8, 8).sum(0)
        pre2 = mma_chain([(_f32(l1), _f32(w2))], precise, round_b=True) + _f32(b2)
        sr = (torch.relu(pre2) * _f32(w3)).sum(1) + b3
        r = sr / sig + _f32(noise) / sig
        got += (0.5 * r * r * sig * sig).view(8, 8).sum(0)
    want = torch.from_numpy(want)
    atol = ATOL * max(1.0, want.abs().max().item())
    return ((got.double() - want).abs() / (atol + RTOL * want.abs())).max().item()


@pytest.mark.parametrize("sigma", [0.01, 10.0])
def test_ncsn_forward_rows_meet_the_tolerance_in_the_plain_split(sigma):
    """The NCSN forward reads relu(l1 W2 + b2) as a value, and its loss
    divides score_raw + noise by sigma: at the smallest and the largest
    noise level both splits keep the rows within a tenth of chip_smoke.py's
    row tolerance (rtol 1e-4, atol 1e-5 times the largest row) of f64, so
    the forward ships the plain split; the precise mode is no further."""
    plain, precise = _ncsn_rows(sigma, False), _ncsn_rows(sigma, True)
    assert plain < 0.1, plain
    assert precise < 0.1, precise


def _ddist_rows(dh, w1, rbf, d, off, coeff, passes):
    """ddist[p] = sum_g (dh W1^T)[p, g] rbf[p, g] 2 coeff (d_p - off_g):
    the kernel's row sum after the drbf product."""
    drbf = mma_product(dh, w1.T.contiguous(), passes) if passes else \
        (dh.double() @ w1.T.double())
    return (drbf.double() * rbf.double() * 2 * coeff
            * (d.double()[:, None] - off.double()[None, :])).sum(-1)


def test_one_tf32_pass_misses_the_ddist_tolerance():
    rng = np.random.default_rng(7)
    g_n, f = 51, 128
    delta = 10.0 / (g_n - 1)
    coeff = -0.5 / delta**2
    off = torch.linspace(0.0, 10.0, g_n)
    d = torch.from_numpy(rng.uniform(0.8, 10.0, 64).astype(np.float32))
    rbf = torch.exp(coeff * (d[:, None] - off[None, :]) ** 2)
    dh = torch.from_numpy(rng.normal(0.0, 0.2, (64, f)).astype(np.float32))
    w1 = torch.from_numpy(rng.normal(0.0, 1 / np.sqrt(g_n), (g_n, f))
                          .astype(np.float32))
    want = _ddist_rows(dh, w1, rbf, d, off, coeff, 0)
    atol = ATOL * max(1.0, want.abs().max().item())

    def within(got):
        return bool(((got - want).abs() <= atol + RTOL * want.abs()).all())

    assert within(_ddist_rows(dh, w1, rbf, d, off, coeff, 3))
    assert not within(_ddist_rows(dh, w1, rbf, d, off, coeff, 1))


def test_split_is_exact():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 2**-10 + 2**-11, -3.14159,
                      1e-30, 123456.789], dtype=torch.float32)
    hi = tf32_trunc(x)
    assert torch.equal((_bits(hi) & 0x1FFF), torch.zeros_like(_bits(hi)))
    lo = x - hi
    assert torch.equal(hi + lo, x)  # the remainder is exact in f32
    assert (lo.abs() < hi.abs() * 2**-10).all()
    assert hi[1].item() == 1.0 and lo[1].item() == 2**-11
    # the single pass's rounding: ties away from zero
    assert tf32_round(x)[1].item() == 1.0 + 2**-10


def _routes(monkeypatch, module, names):
    taken = []
    for name in names:
        monkeypatch.setattr(module, name,
                            lambda *a, _n=name, **k: taken.append(_n))
    return taken


@pytest.mark.parametrize("n", [32, 128, 256, 512])
def test_schnet_route_follows_its_threshold(monkeypatch, n):
    taken = _routes(monkeypatch, tcf, ("cfconv_fused", "cfconv_fused_sym"))
    z = torch.zeros(1, n, n)
    tcf.cfconv(z, z, torch.zeros(1, n, 8), None, None, None, None, 0.0, 5.0,
               8, symmetric=True)
    tcf.cfconv(z, z, torch.zeros(1, n, 8), None, None, None, None, 0.0, 5.0,
               8, symmetric=False)
    # symmetric dist/env take the symmetric pair at every N (no threshold:
    # it is the faster pair at every bucket on the H100)
    assert taken == ["cfconv_fused_sym", "cfconv_fused"]


@pytest.mark.parametrize("n", [32, 128, 256, 512])
def test_painn_route_is_unchanged(monkeypatch, n):
    taken = _routes(monkeypatch, tpn, ("painn_message_fused",
                                       "painn_message_fused_sym"))
    z = torch.zeros(1, n, n)
    tpn.painn_message(z, z, z, z, z, None, None, None, None, 5.0,
                      symmetric=True)
    # the JAX package's rule (painn_pallas.painn_sym_profitable): from N=256
    assert taken == ["painn_message_fused_sym" if n >= 256
                     else "painn_message_fused"]


def _painn_stack_case(seed, b_n=8, n=32, f=128, r=20, layers=3, cutoff=5.0):
    """Molecule-like PaiNN stack inputs at full width, f32 values in f64:
    the five pair grids (cosine-cutoff gate, unit directions), q0 and the
    11 weight stacks."""
    rng = np.random.default_rng(seed)
    pos = rng.normal(scale=1.6, size=(b_n, n, 3))
    d = np.linalg.norm(pos[:, :, None] - pos[:, None], axis=-1)
    eye = np.eye(n, dtype=bool)[None]
    gate = np.where((d < cutoff) & ~eye, 0.5 * (np.cos(np.pi * d / cutoff) + 1.0), 0.0)
    vec = (pos[:, None] - pos[:, :, None]) / np.where(eye, 1.0, d)[..., None]
    grids = [d, gate] + [np.where(eye, 0.0, vec[..., c]) for c in range(3)]

    def w(*shape):
        return rng.normal(0.0, 1.0 / np.sqrt(shape[-2]), shape)

    def bias(*shape):
        return rng.normal(0.0, 0.1, shape)

    stacked = [w(layers, f, f), bias(layers, f), w(layers, f, 3 * f), bias(layers, 3 * f),
               w(layers, r, 3 * f), bias(layers, 3 * f), w(layers, f, 2 * f),
               w(layers, 2 * f, f), bias(layers, f), w(layers, f, 3 * f), bias(layers, 3 * f)]

    def f64(a):
        return torch.from_numpy(np.asarray(_f32(a), dtype=np.float64))

    return [f64(g) for g in grids], f64(rng.normal(size=(b_n, n, f))), [f64(s) for s in stacked]


def _painn_stack_emulated(grids, q0, stacked, dense_precise, cutoff=5.0, eps=1e-8):
    """painn_stack.cu's arithmetic in f32: each dense product [rows x 128] x
    [128 x 128] in 3xTF32 (``dense_precise``: the precise mode, else the
    plain split), the gated filter [phi; 1] gate [Wk; bk] in the plain split
    with [Wk; bk] split once (rounded), everything else in f32."""
    d, gate, dx, dy, dz = (g.float() for g in grids)
    wd1, bd1, wd2, bd2, wk, bk, wmix, w1, b1, w2, b2 = (s.float() for s in stacked)
    b_n, n, f = q0.shape
    r = wk.shape[1]
    delta = cutoff / (r - 1)

    def mm(*pairs):
        return mma_chain(list(pairs), dense_precise)

    silu = torch.nn.functional.silu
    phi = torch.exp((-0.5 / delta**2) * (d[..., None] - delta * torch.arange(r)) ** 2)
    a = torch.cat([phi, torch.ones_like(phi[..., :1]), torch.zeros_like(phi[..., :3])], -1)
    a = (a * gate[..., None]).reshape(-1, r + 4)
    q, mu = q0.float().reshape(-1, f), torch.zeros(b_n * n, 3 * f)
    for k in range(wd1.shape[0]):
        x = mm((silu(mm((q, wd1[k])) + bd1[k]), wd2[k])) + bd2[k]
        wkb = torch.cat([wk[k], bk[k][None], torch.zeros(3, 3 * f)])
        w = mma_chain([(a, wkb)], False, round_b=True).view(b_n, n, n, 3 * f)
        wx = w * x.view(b_n, 1, n, 3 * f)
        muv = mu.view(b_n, 1, n, 3 * f)
        dmu = torch.cat([(wx[..., f:2 * f] * dc[..., None]).sum(2)
                         + (wx[..., 2 * f:] * muv[..., c * f:c * f + f]).sum(2)
                         for c, dc in enumerate((dx, dy, dz))], -1)
        qp, mup = q + wx[..., :f].sum(2).reshape(-1, f), mu + dmu.reshape(-1, 3 * f)
        v = [mm((mup[:, c * f:c * f + f], wmix[k][:, :f])) for c in range(3)]
        ws = [mm((mup[:, c * f:c * f + f], wmix[k][:, f:])) for c in range(3)]
        vn = torch.sqrt(v[0] * v[0] + v[1] * v[1] + v[2] * v[2] + eps)
        h = silu(mm((qp, w1[k][:f]), (vn, w1[k][f:])) + b1[k])
        sv = mm((h, w2[k][:, 2 * f:])) + b2[k][2 * f:]
        q = (qp + (mm((h, w2[k][:, :f])) + b2[k][:f])) \
            + sv * (v[0] * ws[0] + v[1] * ws[1] + v[2] * ws[2])
        gv = mm((h, w2[k][:, f:2 * f])) + b2[k][f:2 * f]
        mu = torch.cat([mup[:, c * f:c * f + f] + gv * ws[c] for c in range(3)], -1)
    return q.view(b_n, n, f), mu.view(b_n, n, 3 * f)


@pytest.mark.parametrize("seed", [0, 1])
def test_painn_stack_needs_the_precise_mode_for_its_dense_layers(seed):
    """painn_stack.cu chains six dense products per block through L = 3
    blocks (F = 128) and the gated filter of each message pass. On 8 graphs
    of 32 atoms the precise mode for the dense layers, with the filter in
    the plain split, stays within a quarter of chip_smoke.py's stack
    tolerance (rtol 1e-4, atol 1e-5 times the largest magnitude) of the f64
    stack; the plain split's truncating accumulation in the dense layers
    misses it (the filter's plain split feeds the messages linearly and
    costs nothing there)."""
    grids, q0, stacked = _painn_stack_case(seed)
    want = tpn.painn_stack_reference(*grids, q0, stacked, 5.0)

    def ratio(got):
        out = 0.0
        for g, w in zip(got, want):
            atol = ATOL * max(1.0, w.abs().max().item())
            out = max(out, ((g.double() - w).abs() / (atol + RTOL * w.abs())).max().item())
        return out

    precise = ratio(_painn_stack_emulated(grids, q0, stacked, True))
    assert precise < 0.25, precise
    plain = ratio(_painn_stack_emulated(grids, q0, stacked, False))
    assert plain > 1.0, plain
