"""``utils/flops`` and ``ops/se3_basis`` of the port against the JAX
package's: every count bitwise, the product counts against PyTorch's own
``FlopCounterMode`` on the plain forwards, the executed pair fraction
against a brute-force count over the model of the device tile list
(``tests/test_torch_port_tile_schemes.tile_list``), and the SE(3) basis at
f64 against JAX's, its equivariance identities and its gradient."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from geossl_tpu.ops import se3_basis as jse3
from geossl_tpu.utils import flops as jflops
from geossl_tpu_torch.config import ModelConfig
from geossl_tpu_torch.ops import cfconv as tcf
from geossl_tpu_torch.ops import painn as tpn
from geossl_tpu_torch.ops import se3_basis as tse3
from geossl_tpu_torch.train.common import make_backbone
from geossl_tpu_torch.utils import flops as tflops
from tests.test_torch_port_tile_schemes import TILE, tile_list

# Six test workers share the machine's cores: one intra-op thread each.
torch.set_num_threads(1)


def same(a, b):
    assert (a.matmul, a.elementwise, a.transcendental) == \
        (b.matmul, b.elementwise, b.transcendental)


# -- flops ----------------------------------------------------------------------

GRID = list(itertools.product((1, 29, 32, 128, 512), (8, 51), (16, 128),
                              (1, 3, 6), ("schnet", "painn")))


@pytest.mark.parametrize("n,g,f,blocks,model", GRID)
def test_counts_equal_jax_bitwise(n, g, f, blocks, model):
    for frac in (1.0, 0.37):
        same(tflops.schnet_forward(n, g, f, blocks, frac),
             jflops.schnet_forward(n, g, f, blocks, frac))
        same(tflops.painn_forward(n, g, f, blocks, frac),
             jflops.painn_forward(n, g, f, blocks, frac))
        same(tflops.finetune_step(blocks, n, model, blocks == 3, frac),
             jflops.finetune_step(blocks, n, model, blocks == 3, frac))
    same(tflops.ncsn_head_forward(n, f), jflops.ncsn_head_forward(n, f))
    same(tflops.train_step(tflops.schnet_forward(n, g, f, blocks)),
         jflops.train_step(jflops.schnet_forward(n, g, f, blocks)))
    same(tflops.ddm_step(blocks, n, g, f, blocks, model),
         jflops.ddm_step(blocks, n, g, f, blocks, model))
    a, b = tflops.schnet_forward(n, g, f), jflops.schnet_forward(n, g, f)
    same(a.scale(2.5) + a, b.scale(2.5) + b)
    assert a.total == b.total
    assert tflops.mfu(a.total, 0.013, 1e12) == jflops.mfu(b.total, 0.013, 1e12)


def test_peaks_are_the_h100s():
    assert tflops.H100_CARD == "NVIDIA H100 80GB HBM3 (SXM5), 700 W"
    assert (tflops.H100_PEAK_TF32, tflops.H100_PEAK_F32,
            tflops.H100_PEAK_BYTES) == (495e12, 67e12, 3.35e12)
    tf, frac = tflops.mfu(1e12, 0.01)  # 100 TFLOP/s
    assert tf == pytest.approx(100.0) and frac == pytest.approx(100 / 495)
    assert not any(k.startswith("V5E") for k in vars(tflops))
    # scaled pair terms: the executed count of a DDM step is smaller
    dense = tflops.ddm_step(128, 128)
    part = tflops.ddm_step(128, 128, pair_frac=0.4, head_pair_frac=0.2)
    assert part.total < 0.5 * dense.total
    same(tflops.ddm_step(128, 128, pair_frac=1.0, head_pair_frac=1.0), dense)


@pytest.mark.parametrize("model_3d,f", [("schnet", tflops.schnet_forward),
                                        ("painn", tflops.painn_forward)])
def test_product_count_matches_flop_counter_mode(model_3d, f):
    """As tests/test_flops.py holds XLA's count: the analytic products of
    the plain forward at B=8, N=32 within 10% of PyTorch's count."""
    b, n = 8, 32
    rng = np.random.default_rng(0)
    z = torch.as_tensor(rng.integers(1, 9, (b, n)))
    pos = torch.as_tensor(rng.normal(size=(b, n, 3)) * 2, dtype=torch.float32)
    mask = torch.ones(b, n, dtype=torch.bool)
    model = make_backbone(ModelConfig(model_3d=model_3d),
                          torch.Generator().manual_seed(0))
    with FlopCounterMode(display=False) as counter:
        model(z, pos, mask)
    assert f(n).scale(b).matmul == pytest.approx(counter.get_total_flops(),
                                                 rel=0.10)


def _brute(grid, sym, gated):
    """Executed pairs over the tile-list model: each listed tile's pairs
    inside the N x N grid."""
    b, n, _ = grid.shape
    lst, _, _ = tile_list(grid, sym, sparse=gated)
    side = lambda t: min(TILE, n - TILE * t)  # noqa: E731
    return sum(side(pi) * side(pj) for _, pi, pj in lst) / (b * n * n)


def _envs(n, seed=7):
    """Dense (with a padded slot), empty, and Atom3D-like (a 10 A radius
    graph on random-walk chains of different real sizes)."""
    rng = np.random.default_rng(seed)
    dense = np.ones((3, n, n), np.float32)
    dense[2] = 0.0
    empty = np.zeros((2, n, n), np.float32)
    pos = np.cumsum(rng.normal(scale=2.0, size=(4, n, 3)), axis=1)
    mask = np.zeros((4, n), bool)
    for i, real in enumerate((n, n // 2 + 3, n // 3, 1)):
        mask[i, :real] = True
    d = np.linalg.norm(pos[:, :, None] - pos[:, None], axis=-1)
    live = mask[:, :, None] & mask[:, None] & ~np.eye(n, dtype=bool)
    atom3d = ((d < 10.0) & live).astype(np.float32)
    return {"dense": dense, "empty": empty, "atom3d": atom3d}


@pytest.mark.parametrize("n", [32, 100, 128, 256, 512])
def test_executed_pair_fraction_is_the_tile_list_count(n):
    for name, env in _envs(n).items():
        gated = tcf.sparse_auto(n, "auto")
        for symmetric in (True, False):
            got = tflops.executed_pair_fraction(env, "schnet", symmetric)
            want = _brute(env, symmetric, gated) \
                if gated or symmetric else 1.0
            assert got == pytest.approx(want, rel=1e-12), (name, symmetric)
            sym_p = symmetric and tpn.sym_profitable(n)
            got = tflops.executed_pair_fraction(torch.as_tensor(env),
                                                "painn", symmetric)
            want = _brute(env, sym_p, gated) if gated or sym_p else 1.0
            assert got == pytest.approx(want, rel=1e-12), (name, symmetric)
        got = tflops.executed_pair_fraction(env, "ncsn")
        assert got == pytest.approx(_brute(env, False, True), rel=1e-12)
        for model in ("schnet", "painn", "ncsn"):
            assert 0.0 <= tflops.executed_pair_fraction(env, model) <= 1.0
    with pytest.raises(ValueError, match="model"):
        tflops.executed_pair_fraction(np.ones((1, 8, 8)), "transformer")


def test_executed_pair_fraction_follows_the_routes(monkeypatch):
    env = _envs(64)["dense"]
    assert tflops.executed_pair_fraction(env, "painn") == 1.0
    assert tflops.executed_pair_fraction(env, "schnet", symmetric=False) == 1.0
    sym = tflops.executed_pair_fraction(env, "schnet")  # the sym pair at N=64
    assert sym == pytest.approx((8 * 9 / 2) / 64)  # the upper tiles
    monkeypatch.setattr(tpn, "_SYM_MIN_N", 64)  # PaiNN's route moves
    assert tflops.executed_pair_fraction(env, "painn") == pytest.approx(sym)
    monkeypatch.setattr(tcf, "sparse_auto", lambda n, s: True)
    assert tflops.executed_pair_fraction(env, "schnet", False) == \
        pytest.approx(2 / 3)  # the padded slot's tiles are skipped


# -- se3_basis ---------------------------------------------------------------------


def _rotation(seed):
    q, _ = np.linalg.qr(np.random.default_rng(seed).normal(size=(3, 3)))
    if np.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    return q


def test_se3_basis_matches_jax_f64():
    rng = np.random.default_rng(3)
    v = rng.normal(size=(9, 3))
    v[4] = 0.0  # a self-pair
    rot = _rotation(5)
    jax.config.update("jax_enable_x64", True)
    try:  # one jitted program: eager x64 ops would compile one by one
        j_sh, j_basis = jax.jit(lambda x: (jse3.precompute_sh(x, 4),
                                           jse3.get_basis(x, 2)))(
            jnp.asarray(v))
        j_sh = {k: np.asarray(a) for k, a in j_sh.items()}
        j_basis = {k: np.asarray(a) for k, a in j_basis.items()}
    finally:
        jax.config.update("jax_enable_x64", False)
    t_sh = tse3.precompute_sh(torch.as_tensor(v), 4)
    assert sorted(t_sh) == sorted(j_sh)
    for k in j_sh:
        np.testing.assert_allclose(t_sh[k].numpy(), j_sh[k], rtol=1e-10,
                                   atol=1e-14)
    t_basis = tse3.get_basis(torch.as_tensor(v), 2)
    assert sorted(t_basis) == sorted(j_basis)
    for k in j_basis:
        assert t_basis[k].shape == j_basis[k].shape
        np.testing.assert_allclose(t_basis[k].numpy(), j_basis[k], rtol=1e-10,
                                   atol=1e-14)
    for l in range(5):
        np.testing.assert_allclose(
            tse3.wigner_d(l, torch.as_tensor(rot)).numpy(),
            jse3.wigner_d(l, rot), rtol=1e-10, atol=1e-13)
        np.testing.assert_allclose(tse3.wigner_d(l, rot).numpy(),
                                   jse3.wigner_d(l, rot), rtol=1e-10,
                                   atol=1e-13)
    for j, a, b in [(0, 1, 1), (2, 1, 1), (3, 1, 2), (1, 2, 2)]:
        np.testing.assert_allclose(tse3.basis_intertwiner(j, a, b).numpy(),
                                   jse3.basis_intertwiner(j, a, b),
                                   rtol=1e-10, atol=1e-14)


def test_se3_equivariance_identities_f64():
    rot = _rotation(11)
    r = torch.as_tensor(rot)
    v = torch.as_tensor(np.random.default_rng(12).normal(size=(16, 3)))
    sh, sh_r = tse3.precompute_sh(v, 5), tse3.precompute_sh(v @ r.T, 5)
    for l in range(6):
        torch.testing.assert_close(sh_r[l], sh[l] @ tse3.wigner_d(l, r).T,
                                   rtol=1e-9, atol=1e-11)
    # D is a homomorphism, batched rotations too
    r2 = torch.as_tensor(_rotation(13))
    both = torch.stack([r, r2])
    for l in range(4):
        d = tse3.wigner_d(l, both)
        torch.testing.assert_close(tse3.wigner_d(l, r @ r2), d[0] @ d[1],
                                   rtol=1e-10, atol=1e-12)
    b0, br = tse3.get_basis(v, 2), tse3.get_basis(v @ r.T, 2)
    for d_in, d_out in [(1, 1), (2, 1), (1, 2), (2, 2), (0, 2)]:
        k0 = b0[f"{d_in},{d_out}"][:, 0, :, 0]  # [E, 2do+1, 2di+1, nJ]
        kr = br[f"{d_in},{d_out}"][:, 0, :, 0]
        do, di = tse3.wigner_d(d_out, r), tse3.wigner_d(d_in, r)
        torch.testing.assert_close(
            kr, torch.einsum("pm,emnj,qn->epqj", do, k0, di), rtol=1e-9,
            atol=1e-11)


def test_se3_basis_gradient_device_and_dtype():
    v = torch.as_tensor(np.random.default_rng(14).normal(size=(3, 3)),
                        dtype=torch.float64).requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda x: tuple(tse3.get_basis(x, 2).values()), (v,))
    z = torch.zeros((2, 3), dtype=torch.float64, requires_grad=True)
    sum(t.sum() for t in tse3.precompute_sh(z, 3).values()).backward()
    assert torch.isfinite(z.grad).all()
    basis = tse3.get_basis(v.detach().float(), 1)
    assert all(t.dtype == torch.float32 and t.device == v.device
               for t in basis.values())
    assert tse3.basis_intertwiner(1, 1, 1, torch.float32).dtype == torch.float32
