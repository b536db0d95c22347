"""Pair-grid model parallelism in geossl_tpu_torch
(``parallel/pair_parallel.py``, the backbones' ``pair_axis`` paths) on the
CPU: two gloo ranks on a ``(data, pair)`` mesh of 1 x 2, each running its
j-stripe of the pair grid through the plain-mode wrappers (``cfconv_fused``,
``painn_message_fused``: on the CPU their plain versions).

Two ranks are started once for the file (``stripes``, a module fixture).
All in f64, tolerance rtol 1e-10, atol 1e-12:

* SchNet and PaiNN with ``pair_axis="pair"``: the forward pass (graph and
  node representations) and every parameter gradient, summed over the
  ranks as the drivers sum them (``common.backward_share``,
  ``mesh.all_reduce_grads``), against the unsharded module; and the two
  kinds of gradient before that sum: a node-path parameter's gradient on
  each rank is half the whole (a share of one replicated computation), a
  filter weight's are stripe partials that differ between the ranks and
  add up to the whole;
* once per backbone, the stripes (the module run through ``mesh.sharded``
  on the pair mesh) against the JAX package's ``pair_sharded_apply`` on two
  of the suite's eight virtual CPU devices, the weights carried across by
  ``utils/torch_import`` (PaiNN's JAX f32 casts read as f64:
  ``test_torch_port_painn.f64_casts``);
* ``finetune_lba --pair_devices 2`` (both backbones' CLI; f32: rtol 1e-5)
  against the one-process run;
* the refusal of N % D != 0, with the JAX package's message.
"""

import contextlib
import os

import numpy as np
import pytest
import torch

from geossl_tpu_torch.models.painn import PaiNN
from geossl_tpu_torch.models.schnet import SchNet
from geossl_tpu_torch.parallel import mesh as pmesh
from geossl_tpu_torch.parallel import multihost
from geossl_tpu_torch.parallel import pair_parallel as pp
from geossl_tpu_torch.train import common
from geossl_tpu_torch.train import finetune_lba as FL
from tests.test_torch_port_parallel import TINY, free_port, run_ranks

# Six test workers share the machine's cores: one intra-op thread each
# (torch's default, one per core, makes these small ops 10-50x slower
# under that load); the ranks these tests start take the same.
torch.set_num_threads(1)

RTOL, ATOL = 1e-10, 1e-12
SCHNET = dict(hidden_channels=16, num_filters=16, num_interactions=2,
              num_gaussians=8, cutoff=5.0)
PAINN = dict(n_atom_basis=16, n_interactions=2, n_rbf=8, cutoff=5.0)
# per backbone: a node-path parameter after the last message pass (a
# replicated computation only) and a filter weight
KINDS = {"schnet": ("lin1.weight", "interactions.0.mlp.0.weight"),
         "painn": ("mixing.1.intraatomic_context_net.1.weight",
                   "filter_net.weight")}


def molecules(b=3, n=16, seed=21):
    """Padded random-walk molecules (f64), row 0 full, the last one atom."""
    rng = np.random.default_rng(seed)
    z = np.zeros((b, n), np.int64)
    pos = np.zeros((b, n, 3))
    mask = np.zeros((b, n), bool)
    for i in range(b):
        k = n if i == 0 else (1 if i == b - 1 else int(rng.integers(2, n)))
        z[i, :k] = rng.integers(1, 9, k)
        pos[i, :k] = np.cumsum(rng.normal(scale=1.2, size=(k, 3)), 0)
        mask[i, :k] = True
    return torch.from_numpy(z), torch.from_numpy(pos), torch.from_numpy(mask)


def make(model_3d: str, pair_axis=None):
    cls, kw = (SchNet, SCHNET) if model_3d == "schnet" else (PaiNN, PAINN)
    return cls(**kw, pair_axis=pair_axis).double()


def forward_and_grads(model, apply) -> dict:
    """(graph, node) of ``molecules()`` and the gradient of a fixed
    function of both, as a driver takes it: this rank's share, then (with
    ``pre``) the gradients before and after the sum over the ranks."""
    z, pos, mask = molecules()
    graph, node = apply(z, pos, mask)
    rng = np.random.default_rng(5)
    wg = torch.from_numpy(rng.normal(size=graph.shape))
    wn = torch.from_numpy(rng.normal(size=node.shape))
    loss = (graph * wg).sum() + (node * wn).sum()
    common.backward_share(loss, 1)
    out = {"graph": graph.detach(), "node": node.detach(),
           "pre": {k: p.grad.clone() for k, p in model.named_parameters()}}
    common.pmesh.all_reduce_grads(list(model.parameters()),
                                  common.pmesh.current())
    out["grads"] = {k: p.grad.clone() for k, p in model.named_parameters()}
    return out


def _rank_main(rank: int, port: int, outdir: str) -> None:
    torch.set_num_threads(1)
    multihost.initialize(f"127.0.0.1:{port}", 2, rank, device="cpu")
    pp.make_pair_mesh(num_pair=2, num_data=1, device="cpu")
    states = torch.load(os.path.join(outdir, "states.pt"))
    out = {}
    for model_3d in ("schnet", "painn"):
        model = make(model_3d, pp.PAIR_AXIS)
        model.load_state_dict(states[model_3d])
        out[model_3d] = forward_and_grads(
            model, lambda *a, model=model: pmesh.sharded(model, *a))
    z, pos, mask = molecules(n=15)
    try:
        model(z, pos, mask)
        out["odd_n"] = None
    except ValueError as e:
        out["odd_n"] = str(e)
    torch.save(out, os.path.join(outdir, f"rank{rank}.pt"))


def _jax(model_3d: str, pair_axis=None):
    """(the JAX backbone, its flax tree -> the port's state_dict, the
    context its f64 runs need)."""
    from geossl_tpu.models.painn import PaiNN as JPaiNN
    from geossl_tpu.models.schnet import SchNet as JSchNet
    from geossl_tpu_torch.utils.torch_import import (
        painn_state_dict_from_flax,
        schnet_state_dict_from_flax,
    )
    from tests.test_torch_port_painn import f64_casts
    from tests.test_torch_port_schnet import x64

    if model_3d == "schnet":
        return JSchNet(**SCHNET, pair_axis=pair_axis), \
            schnet_state_dict_from_flax, x64

    def painn_ctx():
        ctx = contextlib.ExitStack()
        ctx.enter_context(x64())
        ctx.enter_context(f64_casts())
        return ctx
    return JPaiNN(**PAINN, pair_axis=pair_axis), \
        lambda p: painn_state_dict_from_flax(p, PAINN["n_interactions"]), \
        painn_ctx


def _jax_params(model_3d: str):
    """A JAX backbone's flax tree in f64, and its port state_dict."""
    import jax
    import jax.numpy as jnp

    module, to_port, ctx = _jax(model_3d)
    z, pos, mask = (t.numpy() for t in molecules())
    with ctx():
        params = module.init(
            jax.random.PRNGKey(3), jnp.asarray(z), jnp.asarray(pos),
            jnp.asarray(mask))["params"]
        params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                        params)
    return params, {k: v.double() for k, v in to_port(params).items()}


@pytest.fixture(scope="module")
def stripes(tmp_path_factory):
    """Each rank's results, the unsharded module's, and the JAX backbones'
    flax trees (whose port weights every case uses)."""
    outdir = str(tmp_path_factory.mktemp("stripes"))
    jparams, states = {}, {}
    for model_3d in ("schnet", "painn"):
        jparams[model_3d], states[model_3d] = _jax_params(model_3d)
    torch.save(states, os.path.join(outdir, "states.pt"))
    run_ranks(_rank_main, 2, free_port(), outdir)
    got = [torch.load(os.path.join(outdir, f"rank{r}.pt")) for r in range(2)]
    want = {}
    for model_3d, state in states.items():
        model = make(model_3d)
        model.load_state_dict(state)
        want[model_3d] = forward_and_grads(model, model)
    return got, want, jparams


@pytest.mark.parametrize("model_3d", ["schnet", "painn"])
def test_pair_sharded_forward_and_gradients_match_unsharded_f64(
        stripes, model_3d):
    got, want, _ = stripes
    w = want[model_3d]
    for rank in got:
        r = rank[model_3d]
        for key in ("graph", "node"):
            np.testing.assert_allclose(r[key].numpy(), w[key].numpy(),
                                       rtol=RTOL, atol=ATOL, err_msg=key)
        assert sorted(r["grads"]) == sorted(w["grads"])
        for name, g in w["grads"].items():
            np.testing.assert_allclose(r["grads"][name].numpy(), g.numpy(),
                                       rtol=RTOL, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("model_3d", ["schnet", "painn"])
def test_pair_gradients_are_shares_and_stripe_partials(stripes, model_3d):
    got, want, _ = stripes
    node_path, filt = KINDS[model_3d]
    for rank in got:  # a replicated computation's share: half the whole
        np.testing.assert_allclose(
            rank[model_3d]["pre"][node_path].numpy(),
            want[model_3d]["grads"][node_path].numpy() / 2, rtol=RTOL,
            atol=ATOL)
    parts = [rank[model_3d]["pre"][filt] for rank in got]
    assert not torch.allclose(parts[0], parts[1], rtol=1e-3)
    np.testing.assert_allclose((parts[0] + parts[1]).numpy(),
                               want[model_3d]["grads"][filt].numpy(),
                               rtol=RTOL, atol=ATOL)


def _match_jax_pair_sharded_apply(stripes, model_3d):
    """The port's stripes on its two ranks against the JAX package's
    ``pair_sharded_apply`` on a (data 1, pair 2) mesh of virtual CPU
    devices, f64, the same weights."""
    import jax
    import jax.numpy as jnp

    from geossl_tpu.parallel.pair_parallel import (
        PAIR_AXIS,
        make_pair_mesh,
        pair_sharded_apply,
    )

    got, _, jparams = stripes
    module, _, ctx = _jax(model_3d, PAIR_AXIS)
    apply = jax.jit(pair_sharded_apply(
        lambda p, z, pos, mask: module.apply({"params": p}, z, pos, mask),
        make_pair_mesh(num_pair=2, num_data=1)))
    with ctx():
        z, pos, mask = (jnp.asarray(t.numpy()) for t in molecules())
        graph, node = apply(jparams[model_3d], z, pos, mask)
        graph, node = np.asarray(graph), np.asarray(node)
    for rank in got:
        np.testing.assert_allclose(rank[model_3d]["graph"].numpy(), graph,
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(rank[model_3d]["node"].numpy(), node,
                                   rtol=RTOL, atol=ATOL)


def test_stripes_match_jax_pair_sharded_apply(stripes):
    _match_jax_pair_sharded_apply(stripes, "schnet")


def test_painn_stripes_match_jax_pair_sharded_apply(stripes):
    _match_jax_pair_sharded_apply(stripes, "painn")


def test_pair_axis_refuses_n_not_divisible(stripes):
    got, _, _ = stripes
    for rank in got:
        assert "N % axis_size == 0; got N=15, axis 'pair' size 2" in \
            rank["odd_n"]
    with pytest.raises(ValueError, match="needs a pair mesh"):
        pp.local_stripe(16)


@pytest.mark.parametrize("model_3d", ["schnet", "painn"])
def test_finetune_lba_pair_devices_matches_one_process(tmp_path, model_3d):
    def run(out, *extra):
        FL.main(["--synthetic", "--synthetic_size", "16", "--epochs", "1",
                 "--bucket", "128", "--model_3d", model_3d,
                 "--output_model_dir", str(out), *TINY, *extra])
        return torch.load(os.path.join(out, "model.pth"))

    one = run(tmp_path / "one")
    two = run(tmp_path / "two", "--pair_devices", "2")
    for part in ("model", "graph_pred_linear"):
        for k, v in one[part].items():
            np.testing.assert_allclose(two[part][k].numpy(), v.numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=k)
