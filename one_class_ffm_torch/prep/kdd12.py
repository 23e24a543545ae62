"""KDD12 dataset preparation pipeline (reference script/kdd12.tools/).

Non-interactive CLI covering the whole chain:

  training.csv --filter--> ad.filter.csv + user.filter.csv
               --group---> ad.gby.csv + user.gby.csv + AdID.map
               --encode--> user.{ffm,fm,mf} + ad.{ffm,fm,mf}
               --split---> user.<enc>.{tr,va,te}

Semantics mirror the reference scripts: keep clicked rows with UserID != 0
and ads with > threshold clicks (filter.py:11-29); group ads by AdID in
sorted order so label id == ad row index (ad.py:17-27); group user rows by
(UserID, QueryID, Depth) with '|'-joined mapped ad ids (user.py:24-36);
field layouts per encoder (user_ffm.py:5-8, ad_ffm.py:5-10, *_fm, *_mf).

Usage:
  python -m one_class_ffm_torch.prep.kdd12 all --raw training.csv \
      --out outdir --threshold 100
  (or individual subcommands: filter / group / encode / split)
"""

from __future__ import annotations

import argparse
import csv
import os
import sys
from typing import Dict, List

from .encode import FeatureSpace, encode_csv, merge_fields
from .split import split_file

USER_FFM_FIELDS = [["UserID"], ["QueryID", "Depth"]]
AD_FFM_FIELDS = [["TitleID"], ["DescriptionID"], ["KeywordID"],
                 ["AdID", "DisplayURL", "AdvertiserID"]]
USER_MF_FIELDS = [["UserID"]]
AD_MF_FIELDS = [["AdID"]]
AD_COLS = ["AdID", "DisplayURL", "AdvertiserID", "KeywordID", "TitleID",
           "DescriptionID"]
USER_COLS = ["AdID", "UserID", "QueryID", "Depth"]


def cmd_filter(raw: str, out_dir: str, threshold: int) -> None:
    import pandas as pd

    df = pd.read_csv(raw)
    df = df.loc[(df["Click"] > 0) & (df["UserID"] != 0)]
    counts = df["AdID"].value_counts()
    keep = counts[counts > threshold].index
    df = df.loc[df["AdID"].isin(keep)]
    df[AD_COLS].to_csv(os.path.join(out_dir, "ad.filter.csv"), index=False)
    df[USER_COLS].to_csv(os.path.join(out_dir, "user.filter.csv"), index=False)


def cmd_group(out_dir: str) -> None:
    import pandas as pd

    # ads: one row per AdID (sorted), '|'-joined unique attrs; AdID.map gives
    # the contiguous label id for each AdID (= output row index)
    df = pd.read_csv(os.path.join(out_dir, "ad.filter.csv"))
    ad_map: Dict[str, int] = {}
    with open(os.path.join(out_dir, "ad.gby.csv"), "w") as of, open(
        os.path.join(out_dir, "AdID.map"), "w"
    ) as mf:
        of.write(",".join(AD_COLS) + "\n")
        for cnt, (adid, g) in enumerate(df.groupby("AdID")):
            mf.write(f"{cnt} {adid}\n")
            ad_map[str(adid)] = cnt
            cells = [str(adid)]
            for col in AD_COLS[1:]:
                cells.append("|".join(map(str, g[col].unique())))
            of.write(",".join(cells) + "\n")

    # users: group by (UserID, QueryID, Depth); labels = mapped ad ids
    df = pd.read_csv(os.path.join(out_dir, "user.filter.csv"))
    with open(os.path.join(out_dir, "user.gby.csv"), "w") as of:
        of.write(",".join(USER_COLS) + "\n")
        for key, g in df.groupby(USER_COLS[1:]):
            ads = "|".join(str(ad_map[str(a)]) for a in g["AdID"].unique())
            of.write(ads + "," + ",".join(map(str, key)) + "\n")


def cmd_encode(out_dir: str) -> None:
    user_gby = os.path.join(out_dir, "user.gby.csv")
    ad_gby = os.path.join(out_dir, "ad.gby.csv")
    layouts = {
        "ffm": (USER_FFM_FIELDS, AD_FFM_FIELDS),
        "fm": (merge_fields(USER_FFM_FIELDS), merge_fields(AD_FFM_FIELDS)),
        "mf": (USER_MF_FIELDS, AD_MF_FIELDS),
    }
    for enc, (uf, af) in layouts.items():
        encode_csv(user_gby, uf, os.path.join(out_dir, f"user.{enc}"),
                   label_col="AdID")
        encode_csv(ad_gby, af, os.path.join(out_dir, f"ad.{enc}"))


def cmd_split(out_dir: str, seed: int = 0) -> None:
    for enc in ("ffm", "fm", "mf"):
        p = os.path.join(out_dir, f"user.{enc}")
        if os.path.exists(p):
            split_file(p, seed=seed)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="ocffm-prep-kdd12")
    ap.add_argument("stage", choices=["filter", "group", "encode", "split", "all"])
    ap.add_argument("--raw", default="training.csv", help="raw KDD12 training.csv")
    ap.add_argument("--out", default=".", help="output directory")
    ap.add_argument("--threshold", type=int, default=100,
                    help="min clicks per kept ad")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    if args.stage in ("filter", "all"):
        cmd_filter(args.raw, args.out, args.threshold)
    if args.stage in ("group", "all"):
        cmd_group(args.out)
    if args.stage in ("encode", "all"):
        cmd_encode(args.out)
    if args.stage in ("split", "all"):
        cmd_split(args.out, args.seed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
