"""Standalone scorer / predictor of the PyTorch port.

The counterpart of ``one_class_ffm_tpu/predict.py``: load a saved model
(reference text format or native checkpoint), score users from a feature
file over the full item catalog, and emit top-K item ids (optionally with
scores), with the same cold-user popularity fallback as evaluation.  Every
projection is the port's ``project`` (B8 on the card, its plain version on
the CPU); the score product is a true float32 matmul.  Ties rank the lowest
item id first, as ``jax.lax.top_k`` does: ``torch.topk`` promises no tie
order, so ranking is a stable descending sort (as in the evaluator).

Usage:
    python -m one_class_ffm_torch.predict model.txt items.ffm users.ffm -k 10
    python -m one_class_ffm_torch.predict --ckpt ckpt_dir items.ffm users.ffm
    (add --platform cpu to run without a GPU)
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .data.dataset import pad_fields, read_data, split_fields
from .models.blocks import BlockLayout
from .ops.sparse_ops import project
from .solver.convert import params_from_numpy
from .train import load_checkpoint, load_text_model
from .utils.device import resolve_device

Tensor = torch.Tensor


def load_any_model(model_path: Optional[str], ckpt_dir: Optional[str]):
    """Returns (layout, k, params) from a text model or native checkpoint."""
    if model_path:
        return load_text_model(model_path)
    assert ckpt_dir
    params, _ = load_checkpoint(ckpt_dir)
    with open(os.path.join(ckpt_dir, "config.json")) as fh:
        cfg = json.load(fh)
    k = int(cfg["k"])
    lay = cfg.get("layout")
    if lay is None:
        raise ValueError(
            "checkpoint config.json has no 'layout' entry (older checkpoint); "
            "export a text model with -o and use that instead"
        )
    layout = BlockLayout.make(lay["Du"], lay["Dv"], bool(lay["self_side"]))
    return layout, k, params


def item_side(layout: BlockLayout, tables, v_idx, v_val
              ) -> Tuple[Dict[int, Tensor], Tensor]:
    """Per cross block the item projections Q = X_fj H, and the item self
    sums bt = sum over the item self blocks of <X_fi W, X_fj H> (the user
    self terms are constant per user and left out of the ranking)."""
    Q = {b.f12: project(v_idx[b.fj], v_val[b.fj], tables[b.f12]["H"])
         for b in layout.cross_blocks()}
    bt = torch.zeros(v_idx[0].shape[0], dtype=torch.float32,
                     device=v_idx[0].device)
    for b in layout.item_self_blocks():
        P1 = project(v_idx[b.fi], v_val[b.fi], tables[b.f12]["W"])
        Q1 = project(v_idx[b.fj], v_val[b.fj], tables[b.f12]["H"])
        bt = bt + torch.sum(P1 * Q1, dim=1)
    return Q, bt


def project_users(layout: BlockLayout, tables, u_idx, u_val
                  ) -> Dict[int, Tensor]:
    """Per cross block the users' projections P = X_fi W."""
    return {b.f12: project(u_idx[b.fi], u_val[b.fi], tables[b.f12]["W"])
            for b in layout.cross_blocks()}


def catalog_scores(layout: BlockLayout, P: Dict[int, Tensor],
                   Q: Dict[int, Tensor], bt: Tensor) -> Tensor:
    """(users, items) scores z = bt + sum over the cross blocks (in
    ``cross_blocks`` order) of P Q^T (the reference's pred_z, batched)."""
    z = bt[None, :].expand(next(iter(P.values())).shape[0], bt.shape[0])
    for b in layout.cross_blocks():
        z = z + P[b.f12] @ Q[b.f12].T
    return z


def rank_topk(z: Tensor, top_k: int) -> Tuple[Tensor, Tensor]:
    """(values, ids) of each row's top_k, highest first and the lowest id
    first among equal values (``jax.lax.top_k``'s order): a stable
    descending sort of the row."""
    srt = torch.sort(z, dim=1, descending=True, stable=True)
    return srt.values[:, :top_k], srt.indices[:, :top_k]


def predict_topk_from_model(
    layout: BlockLayout,
    k_rank: int,
    params: Dict[int, Dict[str, np.ndarray]],
    item_path: str,
    user_path: str,
    top_k: int,
    catalog: Optional[int] = None,
    popular: Optional[np.ndarray] = None,
    chunk: int = 2048,
    with_scores: bool = False,
    labeled: bool = False,
    device: torch.device | str = "cuda",
):
    """Score every user row over the catalog; returns (ids, scores|None).
    Runs on the card unless ``device`` names the CPU."""
    device = resolve_device(device)

    # the model's field dims are the ds filter for BOTH sides: unseen feature
    # ids in updated item/user files must drop, not clamp into the tables
    v_raw = read_data(item_path, has_label=False, ds=list(layout.Dv))
    v_fd = split_fields(v_raw, f_override=layout.fv)
    v_pad = pad_fields(v_fd, dtype=np.float32)
    u_raw = read_data(user_path, has_label=labeled, ds=list(layout.Du))
    u_fd = split_fields(u_raw, f_override=layout.fu)
    u_pad = pad_fields(u_fd, dtype=np.float32)

    def dev(a) -> Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    # the tables go to float32 whatever the model's dtype
    tables = params_from_numpy(params, device, torch.float32)
    Q, bt = item_side(layout, tables, [dev(a) for a in v_pad.idx],
                      [dev(a) for a in v_pad.val])

    cat = int(min(catalog or v_fd.m, v_fd.m))
    pop = np.zeros(v_pad.m, np.float32)
    if popular is not None:
        npop = min(len(popular), v_pad.m)
        pop[:npop] = popular[:npop]
    pop_t = dev(pop)

    ids_out, score_out = [], []
    cold_all = u_pad.row_nnz == 0
    for lo in range(0, u_fd.m, chunk):
        sl = slice(lo, lo + chunk)
        P = project_users(layout, tables, [dev(a[sl]) for a in u_pad.idx],
                          [dev(a[sl]) for a in u_pad.val])
        z = torch.where(dev(cold_all[sl])[:, None], pop_t[None, :],
                        catalog_scores(layout, P, Q, bt))
        vals, ids = rank_topk(z[:, :cat], top_k)
        ids_out.append(ids.cpu().numpy())
        if with_scores:
            score_out.append(vals.cpu().numpy())
    ids = np.concatenate(ids_out)[: u_fd.m]
    scores = np.concatenate(score_out)[: u_fd.m] if with_scores else None
    return ids, scores


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="ocffm-predict")
    ap.add_argument("model", nargs="?", default=None,
                    help="text model file (from -o / save_text_model)")
    ap.add_argument("item_file")
    ap.add_argument("user_file", help="user feature rows to score (no labels)")
    ap.add_argument("--ckpt", default=None, help="native checkpoint dir instead")
    ap.add_argument("-k", "--top-k", type=int, default=10)
    ap.add_argument("--catalog", type=int, default=None,
                    help="restrict ranking to the first N item ids")
    ap.add_argument("--scores", action="store_true",
                    help="emit id:score pairs instead of bare ids")
    ap.add_argument("--labeled", action="store_true",
                    help="user file rows start with a label block (ignored)")
    ap.add_argument("--popular-from", default=None,
                    help="labeled training file to build the popularity "
                         "prior for cold users (otherwise cold users score 0)")
    ap.add_argument("--platform", default="cuda", choices=["cuda", "cpu"],
                    help="device to score on: cuda (default; an error when "
                         "no GPU is available) or cpu")
    args = ap.parse_args(argv)
    if not args.model and not args.ckpt:
        ap.error("need a text model or --ckpt")
    if args.platform == "cuda" and not torch.cuda.is_available():
        ap.error("--platform cuda: no CUDA device is available "
                 "(pass --platform cpu to score on the CPU)")
    for path, what in [(args.model, "model"), (args.item_file, "item file"),
                       (args.user_file, "user file")]:
        if path and not os.path.exists(path):
            print(f"ocffm-predict: error: {what} not found: {path}",
                  file=sys.stderr)
            return 1
    layout, k_rank, params = load_any_model(args.model, args.ckpt)
    popular = None
    if args.popular_from:
        pop_raw = read_data(args.popular_from, has_label=True)
        popular = pop_raw.popular
    else:
        # quality trap guard: featureless users rank by the popularity prior
        # in evaluation (reference ffm.cpp:975-977) but have nothing to rank
        # by here without one — warn rather than silently emit score-0 rows
        u_probe = read_data(args.user_file, has_label=args.labeled,
                            ds=list(layout.Du))
        n_cold = int(np.sum(np.diff(u_probe.x_indptr) == 0))
        if n_cold:
            print(
                f"ocffm-predict: warning: {n_cold} user row(s) have no "
                f"(in-vocabulary) features and will score 0 for every item; "
                f"pass --popular-from <train file> to rank them by the "
                f"popularity prior (the evaluator's cold-user fallback)",
                file=sys.stderr,
            )
    ids, scores = predict_topk_from_model(
        layout, k_rank, params, args.item_file, args.user_file,
        args.top_k, catalog=args.catalog, with_scores=args.scores,
        labeled=args.labeled, popular=popular, device=args.platform,
    )
    for i, row in enumerate(ids):
        if args.scores:
            print(",".join(f"{int(j)}:{scores[i][t]:.6g}"
                           for t, j in enumerate(row)))
        else:
            print(",".join(str(int(j)) for j in row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
