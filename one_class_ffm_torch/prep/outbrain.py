"""Outbrain dataset preparation pipeline (reference script/outbrain.tools/).

Non-interactive CLI chain:

  clicks_train.csv + cv_events.csv + promoted_content.csv + documents_meta.csv
    --filter-----> click_filter.csv, events_filter.csv, ad_filter.csv
    --add-label--> events_filter_label.csv (user/context rows with ad-row
                   label ids), ad_filter.csv re-joined with doc meta
    --encode-----> ob.<split>.{ffm,fm,mf} + item.{ffm,fm,mf}
    --sample-----> 20% .sub files for faster eval

Semantics mirror the reference: ads with > threshold clicks
(filter.py:11-15), label = ad row index in the filtered promoted_content
(add_label.py:6-11), context fields platform + parsed geo vs doc ids
(context_ffm.py:5-7, handle_geo), item fields doc ids vs campaign/advertiser
(item_ffm.py:5-7); mf uses uuid / ad_id.
"""

from __future__ import annotations

import argparse
import os
import sys

from .encode import FeatureSpace, encode_csv, geo_handler, merge_fields
from .split import split_file, subsample

CONTEXT_FFM_FIELDS = [["platform", "geo_location"],
                      ["source_id", "publisher_id", "document_id_x"]]
CONTEXT_MF_FIELDS = [["uuid"]]
ITEM_FFM_FIELDS = [["source_id", "publisher_id", "document_id"],
                   ["campaign_id", "advertiser_id"]]
ITEM_MF_FIELDS = [["ad_id"]]
SPECIAL = {"geo_location": geo_handler}


def cmd_filter(raw_dir: str, out_dir: str, threshold: int) -> None:
    import pandas as pd

    clicks = pd.read_csv(os.path.join(raw_dir, "clicks_train.csv"))
    clicks = clicks.loc[clicks["clicked"] > 0]
    counts = clicks["ad_id"].value_counts()
    keep = counts[counts > threshold].index
    clicks = clicks.loc[clicks["ad_id"].isin(keep)]
    clicks.to_csv(os.path.join(out_dir, "click_filter.csv"), index=False)

    events = pd.read_csv(os.path.join(raw_dir, "cv_events.csv"))
    events = events.loc[events["display_id"].isin(clicks["display_id"].unique())]
    events.to_csv(os.path.join(out_dir, "events_filter.csv"), index=False)

    ads = pd.read_csv(os.path.join(raw_dir, "promoted_content.csv"))
    ads = ads.loc[ads["ad_id"].isin(keep)]
    ads.to_csv(os.path.join(out_dir, "ad_filter.csv"), index=False)


def cmd_add_label(raw_dir: str, out_dir: str) -> None:
    import pandas as pd

    ads = pd.read_csv(os.path.join(out_dir, "ad_filter.csv"))
    events = pd.read_csv(os.path.join(out_dir, "events_filter.csv"))
    clicks = pd.read_csv(os.path.join(out_dir, "click_filter.csv"))
    meta = pd.read_csv(os.path.join(raw_dir, "documents_meta.csv"))
    ads = ads.reset_index(drop=True)
    ads["label"] = ads.index.to_series()
    ev = events.merge(clicks, on="display_id", how="left")
    ev = ev.merge(ads, on="ad_id", how="left")
    ev = ev.merge(meta, left_on="document_id_x", right_on="document_id", how="left")
    # rows whose clicked ad is missing from promoted_content have no label;
    # drop them and keep the label column integral (a NaN would upcast the
    # column to float and '12.0' labels break the int parsers downstream)
    ev = ev.dropna(subset=["label"])
    ev = ev.assign(label=ev["label"].astype(int))
    ev.to_csv(os.path.join(out_dir, "events_filter_label.csv"), index=False)

    # item side: promoted_content joined with its document's meta
    item = ads.merge(meta, on="document_id", how="left")
    item.to_csv(os.path.join(out_dir, "item_joined.csv"), index=False)


def cmd_encode(out_dir: str, seed: int = 0) -> None:
    src = os.path.join(out_dir, "events_filter_label.csv")
    # split context rows first (the reference splits the encoded files;
    # splitting the csv then sharing one FeatureSpace across splits is
    # equivalent and keeps ids consistent)
    import pandas as pd

    df = pd.read_csv(src)
    import random

    rd = random.Random()
    rd.seed(seed)
    tags = [("te", 0), ("va", 1)]
    assign = []
    for _ in range(len(df)):
        num = rd.randint(0, 9)
        assign.append("te" if num == 0 else "va" if num == 1 else "tr")
    df = df.assign(_split=assign)
    for tag in ("tr", "va", "te"):
        df.loc[df["_split"] == tag].drop(columns="_split").to_csv(
            os.path.join(out_dir, f"ob.{tag}.csv"), index=False
        )

    layouts = {
        "ffm": CONTEXT_FFM_FIELDS,
        "fm": merge_fields(CONTEXT_FFM_FIELDS),
        "mf": CONTEXT_MF_FIELDS,
    }
    for enc, fields in layouts.items():
        space = FeatureSpace(len(fields))
        for tag in ("tr", "va", "te"):
            encode_csv(
                os.path.join(out_dir, f"ob.{tag}.csv"),
                fields,
                os.path.join(out_dir, f"ob.{tag}.{enc}"),
                label_col="label",
                space=space,
                special=SPECIAL if enc != "mf" else None,
            )

    item_src = os.path.join(out_dir, "item_joined.csv")
    item_layouts = {
        "ffm": ITEM_FFM_FIELDS,
        "fm": merge_fields(ITEM_FFM_FIELDS),
        "mf": ITEM_MF_FIELDS,
    }
    for enc, fields in item_layouts.items():
        encode_csv(item_src, fields, os.path.join(out_dir, f"item.{enc}"))


def cmd_sample(out_dir: str, seed: int = 0) -> None:
    for enc in ("ffm", "fm", "mf"):
        for tag in ("va", "te"):
            p = os.path.join(out_dir, f"ob.{tag}.{enc}")
            if os.path.exists(p):
                subsample(p, seed=seed)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="ocffm-prep-outbrain")
    ap.add_argument("stage",
                    choices=["filter", "add-label", "encode", "sample", "all"])
    ap.add_argument("--raw", default=".", help="dir with raw Kaggle csvs")
    ap.add_argument("--out", default=".", help="output directory")
    ap.add_argument("--threshold", type=int, default=200)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    if args.stage in ("filter", "all"):
        cmd_filter(args.raw, args.out, args.threshold)
    if args.stage in ("add-label", "all"):
        cmd_add_label(args.raw, args.out)
    if args.stage in ("encode", "all"):
        cmd_encode(args.out, args.seed)
    if args.stage in ("sample", "all"):
        cmd_sample(args.out, args.seed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
