"""The training slice's kernels, by their plain versions on the CPU, against
the JAX package: the CFConv backward (``cfconv_pallas._bwd_pallas``) and the
NCSN score head (``ncsn_pallas.ncsn_score_loss``) run in Pallas interpret
mode, as the JAX package's own tests run them, and NCSNv3 in f64.

Tolerances: f32 against interpret mode, rtol 1e-4 with atol 1e-5 times the
output's largest magnitude (summation order differs over up to N*N pair
terms); f64 against the JAX dense math, rtol 1e-10.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geossl_tpu.objectives.ncsn import NCSNv3 as JNCSNv3
from geossl_tpu.ops import cfconv_pallas as jcf
from geossl_tpu.ops import ncsn_pallas as jns
from geossl_tpu_torch.objectives.ncsn import NCSNv3, sigma_ladder
from geossl_tpu_torch.ops import _launch
from geossl_tpu_torch.ops import cfconv as tcf
from geossl_tpu_torch.ops import ncsn as tns
from geossl_tpu_torch.utils.torch_import import ncsn_state_dict_from_flax
from tests import test_torch_port_schnet as S

G, F, EMB = 8, 16, 16


def close(got, want, rtol=1e-4, scale=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    atol = scale * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _cfconv_case(b, n, seed):
    d, e, x, w = S._pair_inputs(b, n, seed, np.float32, f=F, g=G)
    g = np.random.default_rng(seed + 7).normal(size=x.shape).astype(np.float32)
    return d, e, x, g, w


@pytest.mark.parametrize("n", [32, 40])
def test_cfconv_bwd_reference_matches_pallas_interpret(n):
    d, e, x, g, w = _cfconv_case(2, n, seed=n)
    want = jcf._bwd_pallas(*map(jnp.asarray, (d, e, x, g, *w)), 0.0, 5.0, G,
                           "f32", False)
    got = tcf.cfconv_bwd_reference(*map(torch.from_numpy, (d, e, x, g, *w)),
                                   0.0, 5.0, G)
    for name, a, ww in zip(("ddist", "denv", "dx", "dw1", "db1", "dw2", "db2"),
                           got, want):
        close(a.numpy(), np.asarray(ww).reshape(a.shape))


def test_cfconv_bwd_gating_zeroes_denv_on_empty_tiles_only():
    """Gating on (N=64: one 64x64 tile per graph in the JAX kernel): the
    empty graph slot's denv is zero, every other output as gating off."""
    d, e, x, g, w = _cfconv_case(3, 64, seed=5)
    d[2], e[2] = 0.0, 0.0  # an empty graph slot
    args = (*map(jnp.asarray, (d, e, x, g, *w)), 0.0, 5.0, G, "f32")
    gated = jcf._bwd_pallas(*args, True)
    ref = tcf.cfconv_bwd_reference(*map(torch.from_numpy, (d, e, x, g, *w)),
                                   0.0, 5.0, G)
    denv_ref = ref[1].numpy()
    assert np.abs(denv_ref[2]).max() > 0  # the true cotangent is not zero
    np.testing.assert_array_equal(np.asarray(gated[1])[2], 0.0)
    close(np.asarray(gated[1])[:2], denv_ref[:2])
    for k in (0, 2, 3, 4, 5, 6):
        close(ref[k].numpy(), np.asarray(gated[k]).reshape(ref[k].shape))


def _ncsn_case(b, n, seed, dtype=np.float32, emb=EMB):
    rng = np.random.default_rng(seed)
    z, pos, mask = S.molecules(b, n, seed, dtype=dtype)
    pm = mask[:, :, None] & mask[:, None, :] & ~np.eye(n, dtype=bool)
    diff = pos[:, :, None] - pos[:, None]
    dist = np.where(pm, np.sqrt((diff * diff).sum(-1) + (~pm)), 0).astype(dtype)
    sel = (pm & np.triu(np.ones((n, n), bool), 1)).astype(dtype)
    noise = rng.normal(size=(b, n, n)).astype(dtype)
    sigma = sigma_ladder(10.0, 0.01, 50)[rng.integers(0, 50, b)].astype(dtype)
    u = rng.normal(scale=0.5, size=(b, n, emb)).astype(dtype)
    ws = [rng.uniform(-0.4, 0.4, size=s).astype(dtype)
          for s in tns.weight_shapes(emb)]
    return (dist, noise, sel, sigma, u), ws, mask


def test_ncsn_reference_and_grads_match_pallas_interpret():
    grid, ws, _ = _ncsn_case(3, 32, seed=2)
    g_rows = np.random.default_rng(9).normal(size=grid[0].shape[:2])
    g_rows = g_rows.astype(np.float32)
    jgrid = list(map(jnp.asarray, grid))
    jgrid[3] = jgrid[3][:, None]

    def f(u, *w):
        return jns.ncsn_score_loss(*jgrid[:4], u, *w, 2.0)

    want_rows, vjp = jax.vjp(f, jgrid[4], *map(jnp.asarray, ws))
    want = vjp(jnp.asarray(g_rows))
    tgrid = list(map(torch.from_numpy, grid))
    tws = list(map(torch.from_numpy, ws))
    close(tns.ncsn_score_loss_reference(*tgrid, *tws, 2.0).numpy(), want_rows)
    got = tns.ncsn_score_bwd_reference(*tgrid, torch.from_numpy(g_rows), *tws,
                                       anneal=2.0)
    for name, a, w in zip(("u",) + tns.WEIGHT_NAMES, got, want):
        close(a.numpy(), np.asarray(w).reshape(a.shape))
    # the CPU wrappers take the plain versions and launch nothing
    _launch.reset_launch_counts()
    np.testing.assert_array_equal(
        tns.ncsn_score_fwd(*tgrid, *tws, anneal=2.0).numpy(),
        tns.ncsn_score_loss_reference(*tgrid, *tws, 2.0).numpy())
    assert tns.ncsn_score_fwd.launches == 0


@pytest.mark.parametrize("use_kernel", [False, True])
def test_ncsnv3_matches_jax_f64(use_kernel):
    """Weights carried across by ncsn_state_dict_from_flax, sigmas/noise
    injected; use_kernel routes through ops/ncsn (its plain version here)."""
    grid, _, mask = _ncsn_case(3, 24, seed=4, dtype=np.float64)
    dist, noise, sel, sigma, _ = grid
    h = np.random.default_rng(5).normal(size=(3, 24, EMB))
    gm = np.array([True, True, False])
    head = JNCSNv3(emb_dim=EMB)
    with S.x64():
        params = head.init(jax.random.PRNGKey(0), None, jnp.asarray(h),
                           jnp.asarray(dist), jnp.asarray(sel > 0),
                           sigmas=jnp.asarray(sigma), noise=jnp.asarray(noise))
        params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                        params["params"])
        want = float(head.apply({"params": params}, None, jnp.asarray(h),
                                jnp.asarray(dist), jnp.asarray(sel > 0),
                                jnp.asarray(gm), sigmas=jnp.asarray(sigma),
                                noise=jnp.asarray(noise)))
    port = NCSNv3(emb_dim=EMB, use_kernel=use_kernel).double()
    port.load_state_dict(ncsn_state_dict_from_flax(params))
    got = port(torch.from_numpy(h), torch.from_numpy(dist),
               torch.from_numpy(sel > 0), torch.from_numpy(gm),
               sigmas=torch.from_numpy(sigma), noise=torch.from_numpy(noise))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.item(), want, rtol=1e-10)


def test_ncsnv3_init_and_draws_are_seeded_and_reference_shaped():
    a = NCSNv3(emb_dim=EMB, generator=torch.Generator().manual_seed(1))
    b = NCSNv3(emb_dim=EMB, generator=torch.Generator().manual_seed(1))
    sd = a.state_dict()
    assert sorted(sd) == sorted(list(tns.WEIGHT_NAMES) + ["out0_h.weight"])
    for k, v in sd.items():
        assert torch.equal(v, b.state_dict()[k]), k
    bound = (6.0 / (1 + 2 * EMB)) ** 0.5
    assert sd["w_od"].abs().max() <= bound
    assert sd["out0_h.weight"].abs().max() <= bound
    assert torch.count_nonzero(sd["b_od"]) == 0
    np.testing.assert_allclose(a.sigmas.numpy(), sigma_ladder(10.0, 0.01, 50))
    grid, _, mask = _ncsn_case(2, 12, seed=3)
    h = torch.randn(2, 12, EMB, generator=torch.Generator().manual_seed(0))
    args = (h, torch.from_numpy(grid[0]), torch.from_numpy(grid[2] > 0))
    l1 = a(*args, generator=torch.Generator().manual_seed(7))
    l2 = a(*args, generator=torch.Generator().manual_seed(7))
    assert torch.isfinite(l1) and l1.item() == l2.item()
    with pytest.raises(ValueError, match="together"):
        a(*args, sigmas=torch.ones(2))


def test_refuse_grad_helper():
    w = torch.zeros(3, requires_grad=True)
    with pytest.raises(NotImplementedError, match="inference only"):
        _launch.refuse_grad("schnet_stack", "it is inference only",
                            torch.zeros(2), w)
    with torch.no_grad():
        _launch.refuse_grad("schnet_stack", "-", w)
    _launch.refuse_grad("schnet_stack", "-", torch.zeros(3))


def test_kernel_wrappers_refuse_other_devices():
    meta = [torch.zeros(s, device="meta") for s in
            ((1, 8, 8),) * 3 + ((1,), (1, 8, EMB))]
    ws = [torch.zeros(s, device="meta") for s in tns.weight_shapes(EMB)]
    with pytest.raises(ValueError, match="no kernel"):
        tns.ncsn_score_fwd(*meta, *ws, anneal=2.0)
    with pytest.raises(ValueError, match="no kernel"):
        tcf.cfconv_bwd(*(torch.zeros(1, 8, 8, device="meta"),) * 2,
                       torch.zeros(1, 8, F, device="meta"),
                       torch.zeros(1, 8, F, device="meta"),
                       torch.zeros(G, F, device="meta"),
                       torch.zeros(F, device="meta"),
                       torch.zeros(F, F, device="meta"),
                       torch.zeros(F, device="meta"), 0.0, 5.0, G)
