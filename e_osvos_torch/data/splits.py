"""YouTube-VOS train/val split generation (category-balanced), port of
``e_osvos_tpu/data/splits.py``.

A validation split of ``num_val`` sequences is drawn round-robin over the
object categories, rarest first, so rare categories are represented; the
rest is the train split. Reads the YouTube-VOS ``meta.json``."""

from __future__ import annotations

import json
import os
import random
from typing import Dict, List, Tuple


def category_balanced_split(meta_json_path: str, num_val: int = 100,
                            seed: int = 123) -> Tuple[List[str], List[str]]:
    """Returns (train_names, val_names)."""
    with open(meta_json_path) as f:
        videos = json.load(f)["videos"]

    by_category: Dict[str, List[str]] = {}
    for name, v in videos.items():
        cats = {o.get("category", "unknown") for o in v["objects"].values()}
        for c in cats:
            by_category.setdefault(c, []).append(name)

    rng = random.Random(seed)
    for seqs in by_category.values():
        rng.shuffle(seqs)
    # categories by frequency (the rarest is picked first in each round)
    cats_sorted = sorted(by_category, key=lambda c: len(by_category[c]))

    val: List[str] = []
    taken = set()
    while len(val) < num_val:
        progressed = False
        for c in cats_sorted:
            if len(val) >= num_val:
                break
            while by_category[c]:
                cand = by_category[c].pop()
                if cand not in taken:
                    val.append(cand)
                    taken.add(cand)
                    progressed = True
                    break
        if not progressed:
            break
    train = sorted(n for n in videos if n not in taken)
    return train, sorted(val)


def write_split_files(out_dir: str, train: List[str], val: List[str],
                      prefix: str = "train_dev_random_123") -> None:
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"{prefix}_train.txt"), "w") as f:
        f.write("\n".join(train) + "\n")
    with open(os.path.join(out_dir, f"{prefix}_val.txt"), "w") as f:
        f.write("\n".join(val) + "\n")


def main(argv=None):  # pragma: no cover - thin CLI
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("meta_json")
    p.add_argument("out_dir")
    p.add_argument("--num-val", type=int, default=100)
    p.add_argument("--seed", type=int, default=123)
    args = p.parse_args(argv)
    train, val = category_balanced_split(args.meta_json, args.num_val,
                                         args.seed)
    write_split_files(args.out_dir, train, val)
    print(f"train={len(train)} val={len(val)}")


if __name__ == "__main__":  # pragma: no cover
    main()
