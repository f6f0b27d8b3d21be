"""One-command checkpoint ingestion: a diffusers InstructPix2Pix directory
(or a transformers ``CLIPModel`` directory with ``--clip``) -> the port's
ingest cache.

JAX counterpart: ``tools/ingest_checkpoint.py`` (which writes an orbax
cache that only the JAX package reads). Point it at a local checkpoint
directory (the layout ``huggingface-cli download timbrooks/instruct-pix2pix``
produces: ``unet/ vae/ text_encoder/ tokenizer/``) and it

1. loads the state dicts into the port's names
   (``diffusion/weights.load_ip2p_checkpoint`` / ``load_clip_checkpoint``;
   ``.safetensors`` files need the ``safetensors`` package here),
2. writes them as ``torch.save`` files with ``manifest.json``
   (``weights.save_ingested``), which load back with ``torch.load(...,
   weights_only=True)`` alone, on a machine without ``safetensors``, and
3. copies the tokenizer vocabulary (``vocab.json`` + ``merges.txt``) next
   to the cache and, unless ``--no-vendor-tokenizer``, into the port's
   ``dge_tpu_torch/assets/tokenizer/``, where ``load_tokenizer`` finds it.

``launch --train``'s ``system.ip2p_checkpoint`` and
``system.clip_checkpoint`` then take the output directory as they take a
checkpoint directory.

Usage:
  python -m dge_tpu_torch.tools.ingest_checkpoint SRC [--out DIR] [--clip] \\
      [--no-vendor-tokenizer]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def ingest(src: str, out: str, vendor_tokenizer: bool = True,
           kind: str = "ip2p") -> str:
    """Ingest ``src`` into ``out``; returns the cache directory."""
    from dge_tpu_torch.diffusion import tokenizer as T
    from dge_tpu_torch.diffusion import weights as W

    src = os.path.abspath(src)
    print(f"[ingest] converting {src} ({kind}) ...", flush=True)
    t0 = time.time()
    if kind == "clip":
        params = W.load_clip_checkpoint(src)
        tok_src = src  # transformers keeps the vocabulary at its root
    else:
        params = W.load_ip2p_checkpoint(src)
        tok_src = os.path.join(src, "tokenizer")
    out_dir = W.save_ingested(out, params, {"source": src, "kind": kind})

    tok_files = [p for p in ("vocab.json", "merges.txt")
                 if os.path.exists(os.path.join(tok_src, p))]
    if len(tok_files) == 2:
        dests = [os.path.join(out_dir, "tokenizer")]
        if vendor_tokenizer:
            dests.append(os.path.abspath(T.ASSETS_TOKENIZER_DIR))
        for d in dests:
            os.makedirs(d, exist_ok=True)
            for p in tok_files:
                shutil.copy(os.path.join(tok_src, p), os.path.join(d, p))
        print(f"[ingest] tokenizer vocab copied to {dests}", flush=True)
    else:
        print("[ingest] WARNING: no tokenizer vocab.json + merges.txt in the "
              "source: text ids fall back to hashing", file=sys.stderr)
    with open(os.path.join(out_dir, "manifest.json")) as f:
        counts = json.load(f)["param_counts"]
    print(f"[ingest] wrote {out_dir} in {time.time() - t0:.1f} s: "
          + ", ".join(f"{k}={v / 1e6:.1f}M" for k, v in counts.items()),
          flush=True)
    key = "clip_checkpoint" if kind == "clip" else "ip2p_checkpoint"
    print(f"[ingest] use with: python -m dge_tpu_torch.launch --train "
          f"system.{key}={out_dir}")
    return out_dir


def main(argv=None) -> str:
    ap = argparse.ArgumentParser()
    ap.add_argument("src", help="local diffusers InstructPix2Pix checkpoint "
                    "directory (a transformers CLIPModel directory with "
                    "--clip)")
    ap.add_argument("--out", default=None, help="cache directory (default "
                    "outputs/weights/<kind>_torch)")
    ap.add_argument("--clip", action="store_true",
                    help="ingest a transformers CLIPModel (the edit metrics' "
                    "towers, system.clip_checkpoint)")
    ap.add_argument("--no-vendor-tokenizer", action="store_true",
                    help="do not copy the vocabulary into "
                    "dge_tpu_torch/assets/tokenizer/")
    args = ap.parse_args(argv)
    kind = "clip" if args.clip else "ip2p"
    out = args.out or os.path.join(REPO, "outputs", "weights",
                                   f"{kind}_torch")
    return ingest(args.src, out, vendor_tokenizer=not args.no_vendor_tokenizer,
                  kind=kind)


if __name__ == "__main__":
    main()
