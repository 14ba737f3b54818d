"""Offline consolidation of a checkpoint into one fp32 ``.npz`` of its
weights (counterpart of ``deepspeed_tpu/checkpoint/zero_to_fp32.py``).

Usage::

    python -m deepspeed_tpu_torch.checkpoint.zero_to_fp32 <ckpt_dir> <out.npz>

``<ckpt_dir>`` is a run directory (its ``latest`` file is followed) or
one ``<dir>/<tag>`` directory, written by either package.  The entries
carry the JAX names (``.params['h_0']['attn']['qkv']['kernel']``).
"""

import argparse
import os
import sys

from deepspeed_tpu_torch.checkpoint.engine import _META, consolidate


def resolve_tag_dir(path):
    if os.path.exists(os.path.join(path, _META)) or \
            os.path.exists(os.path.join(path, "model_states.npz")):
        return path
    latest = os.path.join(path, "latest")
    if os.path.exists(latest):
        with open(latest) as f:
            return os.path.join(path, f.read().strip())
    raise FileNotFoundError(f"{path} is not a checkpoint directory")


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Merge a deepspeed_tpu checkpoint into a single fp32 "
                    ".npz of model weights.")
    p.add_argument("checkpoint_dir")
    p.add_argument("output_file")
    p.add_argument("--prefix", default=".params",
                   help="leaf-name prefix of the weights subtree")
    args = p.parse_args(argv)
    out = consolidate(resolve_tag_dir(args.checkpoint_dir), args.output_file,
                      prefix=args.prefix)
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
