"""KKBox (WSDM music recommendation) preparation pipeline.

The reference sweeps a KKBox dataset (``listener.*`` / ``top_song.*`` files,
reference grid.sh:136-138) but ships NO prep code for it — the files were
prepared externally (SURVEY.md §2.2: kkbox.tools absent).  This module
provides the missing pipeline from the public Kaggle KKBox csvs:

  train.csv (msno, song_id, ..., target) + songs.csv + members.csv
    --filter--> positives (target==1) on songs with > threshold plays
    --encode--> listener.{ffm,fm,mf} (user side: one row per listener with
                song-row labels) + top_song.{ffm,fm,mf} (item side)
    --split---> listener.{tr,va,te}.{enc}

Field layouts (chosen to mirror the reference's ffm/fm/mf conventions:
id field first, then categorical side-features):
  listener ffm: [[msno]], [[city, gender, registered_via]]
  top_song ffm: [[song_id]], [[genre_ids, artist_name, language]]
  fm: fields merged; mf: id field only.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict

from .encode import encode_csv, merge_fields
from .split import split_file

LISTENER_FFM_FIELDS = [["msno"], ["city", "gender", "registered_via"]]
LISTENER_MF_FIELDS = [["msno"]]
SONG_FFM_FIELDS = [["song_id"], ["genre_ids", "artist_name", "language"]]
SONG_MF_FIELDS = [["song_id"]]


def cmd_filter(raw_dir: str, out_dir: str, threshold: int) -> None:
    import pandas as pd

    tr = pd.read_csv(os.path.join(raw_dir, "train.csv"))
    pos = tr.loc[tr["target"] == 1, ["msno", "song_id"]]
    counts = pos["song_id"].value_counts()
    keep = counts[counts > threshold].index
    pos = pos.loc[pos["song_id"].isin(keep)]

    songs = pd.read_csv(os.path.join(raw_dir, "songs.csv"))
    songs = songs.loc[songs["song_id"].isin(keep)].reset_index(drop=True)
    # contiguous label id == song row index
    song_map = {sid: i for i, sid in enumerate(songs["song_id"])}
    pos = pos.loc[pos["song_id"].isin(song_map)]
    pos = pos.assign(label=pos["song_id"].map(song_map))

    members = pd.read_csv(os.path.join(raw_dir, "members.csv"))
    # one row per listener with '|'-joined labels
    grouped = (
        pos.groupby("msno")["label"]
        .apply(lambda s: "|".join(map(str, sorted(s.unique()))))
        .reset_index()
    )
    grouped = grouped.merge(members, on="msno", how="left")
    grouped.to_csv(os.path.join(out_dir, "listener.gby.csv"), index=False)
    songs.to_csv(os.path.join(out_dir, "top_song.filter.csv"), index=False)


def cmd_encode(out_dir: str) -> None:
    listener = os.path.join(out_dir, "listener.gby.csv")
    songcsv = os.path.join(out_dir, "top_song.filter.csv")
    layouts = {
        "ffm": (LISTENER_FFM_FIELDS, SONG_FFM_FIELDS),
        "fm": (merge_fields(LISTENER_FFM_FIELDS), merge_fields(SONG_FFM_FIELDS)),
        "mf": (LISTENER_MF_FIELDS, SONG_MF_FIELDS),
    }
    for enc, (lf, sf) in layouts.items():
        encode_csv(listener, lf, os.path.join(out_dir, f"listener.{enc}"),
                   label_col="label")
        encode_csv(songcsv, sf, os.path.join(out_dir, f"top_song.{enc}"))


def cmd_split(out_dir: str, seed: int = 0) -> None:
    for enc in ("ffm", "fm", "mf"):
        p = os.path.join(out_dir, f"listener.{enc}")
        if os.path.exists(p):
            split_file(p, seed=seed)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="ocffm-prep-kkbox")
    ap.add_argument("stage", choices=["filter", "encode", "split", "all"])
    ap.add_argument("--raw", default=".", help="dir with Kaggle KKBox csvs")
    ap.add_argument("--out", default=".", help="output directory")
    ap.add_argument("--threshold", type=int, default=100,
                    help="min positive plays per kept song")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    if args.stage in ("filter", "all"):
        cmd_filter(args.raw, args.out, args.threshold)
    if args.stage in ("encode", "all"):
        cmd_encode(args.out)
    if args.stage in ("split", "all"):
        cmd_split(args.out, args.seed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
