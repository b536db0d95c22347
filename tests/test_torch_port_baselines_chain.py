"""``pretrain_baselines --steps_per_call`` on the CPU, where
``train/common.ChainStep`` runs its steps eagerly (on the card they are CUDA
graph replays, held to eager steps by ``chip_smoke.py``'s
``graph_parity:``), and contextpred's centre draw.

* One ChainStep call of 3 steps of the port's ``Baseline`` (small SchNet,
  f64) against the JAX driver's chain: its ``step_body`` (the step's key
  ``fold_in(epoch_key, state.step)``, ``value_and_grad`` of the objective's
  loss, ``common.apply_updates``) scanned by ``make_chain_step``, for
  charge and contextpred (an objective draw each) and supervised (none).
  The port takes each step's draw from that step's JAX key as the objective
  makes it. Losses and parameters at rtol 1e-10, then the same call
  against three single steps of the port, bitwise.
* The CLI: ``--steps_per_call 2`` for the six objectives gives the per-step
  losses of ``--steps_per_call 1`` bitwise; ``--profile_dir`` is refused.
* ``sample_centers``' Gumbel-max draw: never a padded atom, a graph
  without atoms gets an index in range, uniform over the real atoms (chi
  square), ``index=`` still decides.
* gloo ranks on CUDA refuse ``--steps_per_call`` above 1 in this driver.
"""

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geossl_tpu.models.schnet import SchNet as JSchNet
from geossl_tpu.objectives import contextpred as jcp
from geossl_tpu.objectives import heads as jheads
from geossl_tpu.train import common as jcommon
from geossl_tpu.train import optim as joptim
from geossl_tpu_torch.data.batch import DenseMolBatch
from geossl_tpu_torch.objectives.contextpred import sample_centers
from geossl_tpu_torch.train import common
from geossl_tpu_torch.train import pretrain_baselines as PB
from geossl_tpu_torch.utils import torch_import as TI
from tests import test_torch_port_pretrain as PT
from tests import test_torch_port_schnet as S
from tests.test_torch_port_host import DECAY, LR, _port_chain

# Six test workers share the machine's cores: one intra-op thread each
# (torch's default, one per core, makes these small ops 10-50x slower
# under that load); the ranks these tests start take the same.
torch.set_num_threads(1)

STEPS = 3


@dataclass
class _Item:
    """One step's batch and its injected draw."""
    batch: DenseMolBatch
    draw: object


def _jax_loss(objective, jm):
    """The JAX driver's ``loss_fn(params, batch, rng)`` for ``objective``
    (``geossl_tpu/train/pretrain_baselines.py``); contextpred's masks come
    with the batch, since ``hop_distances`` does not trace under x64."""
    def apply(p, z, pos, mask):
        return jm.apply({"params": p}, z, pos, mask)

    def loss_fn(params, d, rng):
        z, pos, mask = d["z"], d["pos"], d["mask"]
        if objective == "charge":
            masked, sel = jheads.charge_masking(rng, z, mask, 0.3, 9)
            _, node = apply(params["model"], masked, pos, mask)
            logits = jheads.ChargePredictor(9).apply(
                {"params": params["head"]}, node)
            return jheads.charge_loss(logits, z, sel)
        if objective == "contextpred":
            _, sub_node = apply(params["model"], z, pos, d["sub_mask"])
            _, ctx_node = apply(params["context_model"], z, pos,
                                d["ctx_mask"])
            substruct = jnp.einsum("bnf,bn->bf", sub_node, d["centers"])
            ov = d["ov_mask"].astype(jnp.float32)
            context = (jnp.einsum("bnf,bn->bf", ctx_node, ov)
                       / jnp.maximum(ov.sum(-1, keepdims=True), 1.0))
            valid = d["gm"] & (d["ov_mask"].sum(-1) > 0)
            return jcp.contextpred_loss(substruct, context, valid,
                                        PT.CTX["contextpred_neg_samples"])
        hp = PT.baseline_hp("supervised", None)
        graph, _ = apply(params["model"], z, pos, mask)
        pred = jcommon.LinearHead().apply({"params": params["head"]}, graph)
        y = (d["y"][:, hp["task_id"]] - hp["train_mean"]) / hp["train_std"]
        return jcommon.graph_masked_mean(jnp.abs(pred - y), d["gm"]), \
            jnp.zeros(())
    return loss_fn


def _contextpred_masks(d, key):
    """The centres the JAX driver draws from ``key`` and the holed masks."""
    k = PT.CTX["context_hops"]
    l1, l2 = k - 1, k - 1 + PT.CTX["context_csize"]
    bond_adj, centers = PT._context_data(key, jnp.asarray(d["pos"]),
                                         jnp.asarray(d["mask"]))
    with PT.x32():
        hops = jnp.asarray(jcp.hop_distances(np.asarray(bond_adj),
                                             np.asarray(centers), l2))
    sub, ctx, ov = jcp.context_masks(hops, jnp.asarray(d["mask"]), k, l1, l2)
    return dict(centers=np.asarray(centers), sub_mask=np.asarray(sub),
                ctx_mask=np.asarray(ctx), ov_mask=np.asarray(ov))


@pytest.mark.parametrize("objective", ["charge", "contextpred", "supervised"])
def test_baseline_chain_matches_jax_chain_step_f64(objective):
    """Adam with weight decay under a per-epoch cosine over 2 epochs of 2
    steps: the lr changes inside the call."""
    jb = PT.jax_backbone("schnet")
    params = {"model": jb.init(3)}
    if objective == "contextpred":
        params["context_model"] = jb.init(4)
    else:
        params["head"] = PT.jax_head_init(objective, jax.random.PRNGKey(5))
    batches = [PT.make_batch(50 + s) for s in range(STEPS)]
    jm = JSchNet(**S.SMALL)
    with S.x64():
        epoch_key = jax.random.PRNGKey(77)
        keys = [jax.random.fold_in(epoch_key, s) for s in range(STEPS)]
        inputs = [dict(z=d["z"], pos=d["pos"], mask=d["mask"], gm=d["gm"],
                       y=d["y"]) for d in batches]
        if objective == "contextpred":
            for inp, d, key in zip(inputs, batches, keys):
                inp.update(_contextpred_masks(d, key))
        draws = [PT.draw_of(objective, key, d) for d, key in zip(batches, keys)]
        tx = joptim.make_optimizer(LR, 2, 2, DECAY, "CosineAnnealingLR")
        loss_fn = _jax_loss(objective, jm)

        def step_body(state, d, epoch_key):
            rng = jax.random.fold_in(epoch_key, state.step)
            (loss, acc), grads = jax.value_and_grad(loss_fn, has_aux=True)(
                state.params, d, rng)
            return jcommon.apply_updates(state, grads, tx), loss

        chain = jax.jit(jcommon.make_chain_step(step_body),
                        static_argnums=(2,))
        stacked = {k: jnp.stack([jnp.asarray(inp[k]) for inp in inputs])
                   for k in inputs[0]}
        state = jcommon.TrainState.create(
            jax.tree_util.tree_map(jnp.asarray, params), tx)
        state, want = chain(state, stacked, STEPS, epoch_key)
        want = np.asarray(want)
        final = TI.baseline_state_dict_from_flax(
            objective, jax.tree_util.tree_map(np.asarray, state.params),
            "schnet")
        draws = [None if d is None else PT.t(d) for d in draws]

    hp = PT.baseline_hp(objective, None)

    def port():
        net = PB.Baseline(
            objective, jb.port(),
            None if objective == "contextpred" else PT.port_head(objective),
            jb.port() if objective == "contextpred" else None, **hp).double()
        net.load_state_dict(TI.baseline_state_dict_from_flax(
            objective, params, "schnet"))
        return net

    items = [_Item(PT.port_batch(d), draw) for d, draw in zip(batches, draws)]

    def body_of(net):
        return common.pretrain_body(lambda it: net(it.batch, draw=it.draw))

    net = port()
    got, _, sched = _port_chain(net, body_of, STEPS, items)
    assert sched.last_epoch == STEPS
    np.testing.assert_allclose(got[:, 0].numpy(), want, rtol=1e-10)
    for name, p in net.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), final[name].numpy(),
                                   rtol=1e-10, atol=1e-12, err_msg=name)
    single = port()
    got1, _, _ = _port_chain(single, body_of, 1, items)
    assert torch.equal(got1, got)
    for (name, p), q in zip(net.named_parameters(), single.parameters()):
        assert torch.equal(p, q), name


TINY = ["--device", "cpu", "--synthetic", "--synthetic_size", "16",
        "--synthetic_max_atoms", "20", "--emb_dim", "16", "--num_filters",
        "16", "--num_interactions", "2", "--num_gaussians", "8",
        "--batch_size", "4", "--epochs", "2"]


@pytest.mark.parametrize("objective", PB.OBJECTIVES)
def test_cli_steps_per_call_gives_the_single_steps_losses(tmp_path,
                                                          objective):
    """Two epochs of 4 steps: groups of 2 against single steps, every step's
    loss bitwise (each epoch reseeds the objective's draws)."""
    runs = [PB.main([objective, *TINY, "--steps_per_call", k,
                     "--output_model_dir", str(tmp_path / k)])[1]
            for k in ("1", "2")]
    assert len(runs[0]) == 8 and all(np.isfinite(runs[0]))
    assert runs[1] == runs[0]


def test_cli_refuses_profile_dir(tmp_path):
    with pytest.raises(NotImplementedError, match="only pretrain_geossl"):
        PB.main(["contextpred", *TINY, "--steps_per_call", "2",
                 "--profile_dir", str(tmp_path / "trace"),
                 "--output_model_dir", str(tmp_path)])


def _centres(node_mask, seed, draws=1):
    gen = torch.Generator().manual_seed(seed)
    mask = torch.as_tensor(node_mask)
    return torch.stack([sample_centers(gen, mask).argmax(-1)
                        for _ in range(draws)])


def test_centre_draw_picks_real_atoms_and_any_slot_of_an_empty_graph():
    rng = np.random.default_rng(3)
    mask = np.zeros((64, 12), bool)
    for b in range(63):  # holes anywhere; graph 63 has no atom
        mask[b, rng.choice(12, rng.integers(1, 12), replace=False)] = True
    idx = _centres(mask, 5, draws=50)
    assert mask[np.arange(63)[None, :], idx[:, :63].numpy()].all()
    assert ((idx[:, 63] >= 0) & (idx[:, 63] < 12)).all()
    assert len(set(idx[:, 63].tolist())) > 1  # a uniform row, not slot 0


def test_centre_draw_is_uniform_over_real_atoms():
    """24,000 draws over a graph of 6 real atoms among 10 slots: Pearson's
    chi square with 5 degrees of freedom stays below 20.5, its 0.999
    quantile (a seeded draw: the test is deterministic)."""
    mask = np.zeros((2400, 10), bool)
    mask[:, [0, 2, 3, 5, 8, 9]] = True
    idx = _centres(mask, 11, draws=10).flatten().numpy()
    counts = np.bincount(idx, minlength=10)
    assert counts[[1, 4, 6, 7]].sum() == 0
    seen = counts[[0, 2, 3, 5, 8, 9]]
    expect = idx.size / 6
    assert ((seen - expect) ** 2 / expect).sum() < 20.5


def test_centre_index_overrides_the_draw():
    mask = torch.ones(3, 5, dtype=torch.bool)
    index = torch.tensor([4, 0, 2])
    got = sample_centers(torch.Generator().manual_seed(0), mask, index=index)
    assert torch.equal(got, torch.nn.functional.one_hot(index, 5).float())


def test_gloo_ranks_on_cuda_refuse_steps_per_call(monkeypatch, tmp_path):
    """A rank of a gloo group on CUDA: gloo's collectives cannot be
    captured, so the driver refuses before it joins the group (no card
    needed: the device is named, not used)."""
    from geossl_tpu_torch import serve
    from geossl_tpu_torch.parallel import mesh as pmesh

    for k, v in {"RANK": "0", "WORLD_SIZE": "2", "LOCAL_RANK": "0"}.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(serve, "resolve_device",
                        lambda d: torch.device("cuda"))
    monkeypatch.setattr(pmesh, "rank_device",
                        lambda d=None: torch.device("cuda", 0))
    with pytest.raises(SystemExit, match="cannot capture gloo"):
        PB.main(["contextpred", *TINY, "--steps_per_call", "2",
                 "--dist_backend", "gloo", "--output_model_dir",
                 str(tmp_path)])
