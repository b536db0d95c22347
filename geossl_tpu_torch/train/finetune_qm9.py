"""QM9 fine-tuning: single-target regression (counterpart of
``geossl_tpu/train/finetune_qm9.py``; reference ``examples/finetune_qm9.py``).

The JAX driver's flags, defaults and behaviour: the backbone and its
per-backbone head (Linear for SchNet, the halving MLP for PaiNN); y
z-normalized by the train split's mean and std (NumPy, float32, ddof 0;
``finetune_qm9.py:255-257,444-447``); the MAE (``--loss mae``, the
default) or MSE loss over the real graphs; denormalized predictions and
the MAE on val and test every epoch; ``model.pth`` and ``model_final.pth``
with the head and ``y_mean``/``y_std`` (which ``serve.Predictor`` reads)
and ``evaluation_best.npz`` (val/test targets and predictions) at the best
val MAE; the split ``qm9_random_customized_01`` (110k/10k/rest); batch 128,
lr 1e-4 cosine, 100 epochs, buckets 32/64/128. QM9's molecules fit bucket
32: SchNet runs the symmetric CFConv kernels (``cfconv_fwd_sym``/
``cfconv_bwd_sym``; the plain-mode pair with ``--max_num_neighbors``),
PaiNN (``--model_3d painn``) its message-pass kernels (``painn_fwd``/
``painn_bwd``). ``--input_model_file`` takes the ``model.pth`` that
``pretrain_geossl`` writes (backbone only) or a fine-tuned one (with its
head); ``--eval_only`` evaluates a fine-tuned one with its own
``y_mean``/``y_std``. On CUDA by default; ``--device cpu`` takes the plain
versions. ``--steps_per_call k`` runs k optimizer steps per call, as one
CUDA graph replay on the card (``common.ChainStep``).

Run: ``python -m geossl_tpu_torch.train.finetune_qm9 --synthetic --task mu --epochs 3``
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from geossl_tpu_torch.data.bucketing import BucketedLoader
from geossl_tpu_torch.data.qm9 import TARGET_FIELDS, load_qm9
from geossl_tpu_torch.data.splitters import qm9_random_customized_01
from geossl_tpu_torch.data.transforms import random_rotation_transform
from geossl_tpu_torch.parallel import mesh as pmesh
from geossl_tpu_torch.parallel.mesh import prefetch
from geossl_tpu_torch.train import checkpoints, common
from geossl_tpu_torch.train.finetune_lba import LBANet
from geossl_tpu_torch.utils import metrics


def build_parser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    common.add_common_args(p)
    p.add_argument("--task", default="mu", choices=TARGET_FIELDS)
    p.add_argument("--loss", default="mae", choices=["mae", "mse"])
    p.add_argument("--split_seed", type=int, default=0)
    p.add_argument("--use_rotation_transform", action="store_true",
                   help="random-rotation augmentation (datasets_QM9.py:139-140)")
    p.add_argument("--eval_only", action="store_true",
                   help="skip training: evaluate --input_model_file (a "
                        "fine-tuned checkpoint with its head) on the val and "
                        "test splits and exit")
    return p


class QM9Net(LBANet):
    """The backbone and its head under the JAX package's top-level names
    (``model``, ``graph_pred_linear``); ``forward(batch)`` -> the
    normalized prediction [B]. ``plain`` runs the plain versions."""


def make_net(args, cfg, generator: torch.Generator) -> QM9Net:
    return QM9Net(common.make_backbone(cfg, generator),
                  common.make_head(args.model_3d, args.emb_dim, generator),
                  plain=not common.use_kernels(args))


def make_loss_fn(loss_kind: str, mean: float, std: float):
    """The JAX driver's loss (``finetune_qm9.py:49-58``): MAE or MSE of the
    prediction against the z-normalized target, over the real graphs."""
    def loss_fn(net: QM9Net, batch) -> torch.Tensor:
        y = (batch.y[:, 0] - mean) / std
        err = net(batch) - y
        per = err.abs() if loss_kind == "mae" else err ** 2
        return common.graph_masked_mean(per, batch.graph_mask)
    return loss_fn


def predict(net: QM9Net, batch, mean: float, std: float) -> torch.Tensor:
    """Denormalized predictions [B] (``finetune_qm9.py:80-86``)."""
    return net(batch) * std + mean


class Evaluator:
    """``evaluate(net, loader)`` -> {"mae": ...} over the loader's real
    graphs in loader order; ``last[loader]`` keeps that pass's (targets,
    predictions) for ``evaluation_best.npz``."""

    def __init__(self, device, mean: float, std: float):
        self.device, self.mean, self.std = device, mean, std
        self.last = {}

    @torch.no_grad()
    def __call__(self, net: QM9Net, loader) -> dict:
        preds, trues, masks = [], [], []
        for batch in prefetch(loader.epoch(0), self.device):
            preds.append(predict(net, batch, self.mean, self.std))
            trues.append(batch.y[:, 0])
            masks.append(batch.graph_mask)
        gm = torch.cat(masks).cpu().numpy()
        p = torch.cat(preds).cpu().numpy()[gm]
        t = torch.cat(trues).cpu().numpy()[gm]
        self.last[loader] = (t, p)
        return {"mae": metrics.mae(t, p)}


def describe(val: dict, test: dict) -> str:
    return f"val MAE: {val['mae']:.5f}\ttest MAE: {test['mae']:.5f}"


def load_splits(args):
    """(train, val, test) stores with y cut to the ``--task`` column, and
    the train split's (mean, std) of that column, as the JAX driver makes
    them: NumPy on the float32 column (ddof 0)."""
    store = load_qm9(args.data_root, synthetic=args.synthetic,
                     synthetic_size=args.synthetic_size)
    task_id = TARGET_FIELDS.index(args.task)
    splits = [store.select(i)
              for i in qm9_random_customized_01(len(store), args.split_seed)]
    mean = float(splits[0].y[:, task_id].mean())
    std = float(splits[0].y[:, task_id].std())
    for s in splits:
        s.y = np.ascontiguousarray(s.y[:, task_id:task_id + 1])
    return splits, mean, std


def main(argv=None):
    """Fine-tune (or, with ``--eval_only``, evaluate); returns (the net,
    the best val MAE, the test MAE at the best epoch, every step's loss).
    Under ``--eval_only``: (net, val MAE, test MAE, []). None in a
    launcher that started the ranks (``common.start_ranks``)."""
    args = build_parser().parse_args(argv)
    common.check_ported_args(args)
    if common.start_ranks(args, argv, "geossl_tpu_torch.train.finetune_qm9"):
        return None
    mesh, device = common.setup_platform(args)
    cfg = common.model_config_from_args(args)
    common.check_driver_limits(args, cfg, device)
    splits, mean, std = load_splits(args)
    print(f"Train mean: {mean:.6f}\tTrain std: {std:.6f}")
    net = make_net(args, cfg, torch.Generator().manual_seed(args.seed))
    ckpt = common.load_input_model(args, net)
    pmesh.put_replicated(mesh, net.to(device))
    buckets = common.buckets(args)
    transform = random_rotation_transform if args.use_rotation_transform \
        else None
    bs = common.round_batch_to_mesh(args.batch_size, mesh)
    loaders = [BucketedLoader(splits[0], bs, buckets, seed=args.seed,
                              transform=transform)]
    loaders += [BucketedLoader(s, bs, buckets, seed=0, shuffle=False)
                for s in splits[1:]]
    if args.eval_only:
        # the checkpoint's own normalization, when it carries it
        evaluate = Evaluator(device, float(ckpt.get("y_mean", mean)),
                             float(ckpt.get("y_std", std)))
        val, test = evaluate(net, loaders[1]), evaluate(net, loaders[2])
        print(f"eval-only ({args.task})\t{describe(val, test)}")
        return net, val["mae"], test["mae"], []
    evaluate = Evaluator(device, mean, std)
    stats = {"y_mean": torch.tensor(mean, dtype=torch.float32),
             "y_std": torch.tensor(std, dtype=torch.float32)}

    def save_predictions():  # rank 0's (common.run_finetune)
        (vt, vp), (tt, tp) = (evaluate.last[ld] for ld in loaders[1:])
        np.savez(os.path.join(args.output_model_dir, "evaluation_best.npz"),
                 val_target=vt, val_pred=vp, test_target=tt, test_pred=tp)

    out = common.run_finetune(args, net, loaders,
                              make_loss_fn(args.loss, mean, std), evaluate,
                              "mae", False, describe, device,
                              ckpt_extra=stats, on_best=save_predictions)
    test_mae = out["best_test"].get("mae", float("nan"))
    print(f"best val MAE: {out['best']:.5f} (epoch {out['best_epoch']})\t"
          f"test MAE @ best: {test_mae:.5f}")
    if args.output_model_dir:
        checkpoints.save_checkpoint(
            os.path.join(args.output_model_dir, "model_final.pth"),
            common.model_tree(net, stats))
    return net, out["best"], test_mae, out["losses"]


if __name__ == "__main__":
    main()
