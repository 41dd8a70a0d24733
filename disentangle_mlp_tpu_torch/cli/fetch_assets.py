"""Asset bootstrap of the port (disentangle_mlp_tpu/cli/fetch_assets.py):
install and verify the FID Inception weights and the MNIST idx files.

No network access happens implicitly: the download sits behind
``--allow_network``, and every file is verified before it is moved into
place (the FID weights against the sha256 prefix in their published file
name; the MNIST idx files by parsing their binary format and checking the
known shapes). Without the flag the command prints the plan and exits 1.

    dmt-torch-fetch-assets --allow_network [--dest DIR] [--mnist]
    dmt-torch-fetch-assets            # offline: report what is missing + URLs

The default ``--dest`` is the last entry of both packages' weight search
path, so one install serves the JAX package and the port. The command
needs neither JAX nor a GPU. CelebA cannot be fetched automatically (it is
distributed through a consent form); the command prints where to put it.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import tempfile

# The standard pytorch-fid weights file (mseitzer/pytorch-fid release), the
# one the reference's scoring/inception.py points at.
FID_WEIGHTS = {
    "url": ("https://github.com/mseitzer/pytorch-fid/releases/download/"
            "fid_weights/pt_inception-2015-12-05-6726825d.pth"),
    "file": "pt_inception-2015-12-05-6726825d.pth",
    "sha256_prefix": "6726825d",
}

# MNIST idx files (the reference fetches them through torchvision), with
# their known shapes for the structural check after download.
MNIST_FILES = [
    {"url": f"https://storage.googleapis.com/cvdf-datasets/mnist/{name}",
     "file": name, "shape": shape}
    for name, shape in (
        ("train-images-idx3-ubyte.gz", (60000, 28, 28)),
        ("train-labels-idx1-ubyte.gz", (60000,)),
        ("t10k-images-idx3-ubyte.gz", (10000, 28, 28)),
        ("t10k-labels-idx1-ubyte.gz", (10000,)),
    )
]


def _verify_idx(path: str, shape) -> None:
    """Parse the idx file and require the canonical shape: a truncated or
    substituted download cannot pass (``_read_idx`` checks the magic and
    dtype; the reshape checks the length)."""
    from ..data.pipeline import _read_idx

    arr = _read_idx(path)
    if tuple(arr.shape) != tuple(shape):
        raise RuntimeError(
            f"{path}: idx shape {arr.shape} != expected {tuple(shape)} — "
            f"refusing to install")


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def _download(url: str, dest: str, sha256_prefix: str = "",
              verify=None) -> str:
    """Fetch ``url`` → ``dest`` atomically. ``sha256_prefix`` checks the
    digest prefix (the FID file carries it in its published name);
    ``verify(tmp_path)`` runs any extra structural check (idx parsing for
    MNIST). Either failure leaves nothing installed."""
    import urllib.request

    os.makedirs(os.path.dirname(dest) or ".", exist_ok=True)
    # the temp file keeps the destination's suffix: _read_idx opens a ".gz"
    # file with gzip, so a suffixless temp would fail the idx check of
    # every valid gzipped MNIST download
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(dest) or ".",
                               suffix=os.path.splitext(dest)[1])
    os.close(fd)
    try:
        print(f"[fetch] {url}")
        urllib.request.urlretrieve(url, tmp)
        digest = _sha256(tmp)
        if sha256_prefix and not digest.startswith(sha256_prefix):
            raise RuntimeError(
                f"digest mismatch for {url}: got {digest[:16]}…, expected "
                f"prefix {sha256_prefix} — refusing to install")
        if verify is not None:
            verify(tmp)
        os.replace(tmp, dest)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    print(f"[fetch] ok → {dest}")
    return dest


def _mnist_missing(root: str):
    """The subset of MNIST_FILES whose pair (train or t10k) is not already
    under ``root`` in any layout or suffix ``find_mnist_files`` accepts. A
    partly installed set (a failure after the train pair landed) is
    planned again on the next run, not reported complete."""
    from ..data.pipeline import find_mnist_files

    present = {stem: find_mnist_files(root, train=(stem == "train"))
               for stem in ("train", "t10k")}
    return [m for m in MNIST_FILES
            if present["train" if m["file"].startswith("train")
                       else "t10k"] is None]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="explicit, gated download of the FID/MNIST assets")
    ap.add_argument("--allow_network", action="store_true",
                    help="actually download; without it, print the plan "
                         "(this build never touches the network "
                         "implicitly)")
    ap.add_argument("--dest", default=os.path.expanduser(
        "~/.cache/disentangle_mlp_tpu"))
    ap.add_argument("--mnist", action="store_true",
                    help="also fetch the four MNIST idx files")
    ap.add_argument("--mnist_dest", default="")
    ns = ap.parse_args(argv)

    # looked up at call time, so a caller can patch the module's attribute
    from ..eval.inception import find_fid_weights

    plan = []
    have = find_fid_weights()
    weights_dest = os.path.join(ns.dest, FID_WEIGHTS["file"])
    if have:
        print(f"FID Inception weights already present: {have}")
    else:
        plan.append((FID_WEIGHTS["url"], weights_dest,
                     FID_WEIGHTS["sha256_prefix"], None))
    if ns.mnist:
        mdest = ns.mnist_dest or os.path.join(ns.dest, "mnist")
        missing = _mnist_missing(mdest)
        if not missing:
            print(f"MNIST idx files already present under {mdest}")
        else:
            plan.extend(
                (m["url"], os.path.join(mdest, m["file"]), "",
                 (lambda p, shape=m["shape"]: _verify_idx(p, shape)))
                for m in missing)

    if not plan:
        print("nothing to fetch")
        return
    if not ns.allow_network:
        print("offline mode (pass --allow_network to download):")
        for url, dest, _, _ in plan:
            print(f"  {url}\n    -> {dest}")
        print("\nCelebA is consent-gated and cannot be auto-fetched: place "
              "the aligned 64x64-croppable images under "
              "<image_root_{train,val,test}>/<class>/ and run "
              "dmt-reproduce --assets_check.")
        sys.exit(1)

    for url, dest, prefix, verify in plan:
        _download(url, dest, prefix, verify)
    from ..eval.inception import WEIGHT_SEARCH_PATHS
    if (any(d == weights_dest for _, d, _, _ in plan)
            and weights_dest not in WEIGHT_SEARCH_PATHS):
        # a custom --dest is outside the loader's search list: without the
        # variable the FID stack would quietly fall back to random weights
        print(f"NOTE: {weights_dest} is outside the default search paths; "
              f"set FID_INCEPTION_WEIGHTS={weights_dest} for runs to "
              f"find it.")
    print(json.dumps({"fetched": [d for _, d, _, _ in plan]}))


if __name__ == "__main__":
    main()
