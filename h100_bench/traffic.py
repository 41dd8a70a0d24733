"""The one generator of the benchmark's traffic: from a cell's ``feed``
parameters (its file under ``workloads/``) it makes the data that the
program's own loader reads, and the trainer flags that point the loader at
them. The program receives only these inputs.

- ``{"source": "synthetic", "size": N}``: the trainer's
  ``--synthetic_data`` stream of N images an epoch.
- ``{"source": "jpeg_tree", "size": N, "fixtures": [patterns],
  "cache_decoded": "off" | "on"}``: an image folder of N JPEG files (one
  class directory), file i a hard link to fixture i % n of
  ``reference/jpeg``, read through the trainer's decode cache as
  ``--cache_decoded`` says. The tree is made once in a checkout, at a
  fixed path under this folder, and reused; a run then writes nothing.
"""

from __future__ import annotations

import os
import shutil
from pathlib import Path
from typing import Dict, Tuple

from reference import feed as ref_feed

HERE = Path(__file__).resolve().parent
TREE_DIR = HERE / "_jpeg_tree"


def ensure_jpeg_tree(feed: Dict, base: Path = TREE_DIR
                     ) -> Tuple[Path, bool]:
    """(the tree's root, with its class directory inside; whether this
    call made it)."""
    n = feed["size"]
    files = ref_feed.fixtures(feed["fixtures"])
    name = f"n{n}_" + "_".join(Path(f).stem for f in files[:1]) \
        + f"_{len(files)}"
    root = base / name
    if (root / "complete").is_file():
        return root, False
    partial = base / (name + "_partial")
    shutil.rmtree(partial, ignore_errors=True)
    cls = partial / "c0"
    cls.mkdir(parents=True)
    srcs = [ref_feed.JPEG_DIR / f for f in files]
    for i in range(n):
        dst = cls / f"{i:06d}.jpg"
        src = srcs[i % len(srcs)]
        os.link(src, dst)
    (partial / "complete").write_text(f"{n}\n")
    shutil.rmtree(root, ignore_errors=True)
    partial.rename(root)
    return root, True


def program_flags(feed: Dict, tree_base: Path = TREE_DIR
                  ) -> Tuple[Dict, bool]:
    """(trainer flags, the program's ``Config`` fields, for ``feed``;
    whether the JPEG tree was made for them)."""
    if feed["source"] == "synthetic":
        return {"synthetic_data": True,
                "synthetic_train_size": feed["size"]}, False
    if feed["source"] == "jpeg_tree":
        # the class directory is the image folder's one class; the marker
        # file beside it is no image
        root, made = ensure_jpeg_tree(feed, tree_base)
        return {"synthetic_data": False, "image_root_train": str(root),
                "cache_decoded": feed["cache_decoded"]}, made
    raise ValueError(f"unknown feed source {feed['source']!r}")
