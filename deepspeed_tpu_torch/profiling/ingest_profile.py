"""Where the time of HF ingestion goes on the card.

    python -m deepspeed_tpu_torch.profiling.ingest_profile [--layers 2] \
        [--seed 0] [--dir DIR]

Writes ``chip_smoke.py`` phase 6h's Llama-2-7B-width directory (seeded
bf16 weights, two safetensors shards, ``--layers`` of 32) into ``DIR``
(a temporary directory by default), then times on the host clock, each
step ended by ``torch.cuda.synchronize()``, every read just after the
write (warm: the files are in the page cache):

* ``map_s``: ``load_hf_state_dict`` (headers, the copy-on-write maps);
* ``touch_s``: a host copy of every leaf (the pages read from the map);
* ``h2d_mapped_s``: every mapped leaf to the card as it is;
* ``h2d_pinned_s``: the same bytes read with ``readinto`` into one
  pinned buffer per leaf, then a non-blocking copy;
* ``from_hf_s``: ``module_inject.from_hf`` (policy, meta module, check);
* ``engine_s``: ``init_inference(<dir>, dtype="float32")`` as a whole,
  what ``chip_smoke.py`` reports as ``ingest_s``;
* ``set_params_s``: that engine's ``set_params`` of a fresh ``from_hf``
  state (the leaf-by-leaf cast and copy alone).

Prints one JSON object with the bytes and each step's GB/s, the card's
name and power limit.  Needs a CUDA device.
"""

import argparse
import json
import os
import subprocess
import tempfile
import time

import torch


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.monotonic()
    out = fn()
    torch.cuda.synchronize()
    return out, time.monotonic() - t0


def _pinned_reads(path):
    """Every tensor of the directory's safetensors files read into a
    pinned buffer with ``readinto`` and copied to the card."""
    from deepspeed_tpu_torch.module_inject.hf_weights import \
        read_safetensors_header
    out = []
    for fn in sorted(os.listdir(path)):
        if not fn.endswith(".safetensors"):
            continue
        full = os.path.join(path, fn)
        header, _, start = read_safetensors_header(full)
        with open(full, "rb", buffering=0) as f:
            for info in header.values():
                begin, end = info["data_offsets"]
                host = torch.empty(end - begin, dtype=torch.uint8,
                                   pin_memory=True)
                f.seek(start + begin)
                f.readinto(host.numpy())
                out.append(host.to("cuda", non_blocking=True))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dir", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ingest_profile needs a CUDA device")
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.module_inject import from_hf
    from deepspeed_tpu_torch.module_inject.hf_weights import (
        load_hf_state_dict, save_hf_dir)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    cfg = {"model_type": "llama", "hidden_size": 4096,
           "intermediate_size": 11008, "num_hidden_layers": args.layers,
           "num_attention_heads": 32, "num_key_value_heads": 32,
           "vocab_size": 32000, "max_position_embeddings": 4096,
           "rms_norm_eps": 1e-5, "tie_word_embeddings": False}
    g = torch.Generator(device="cuda").manual_seed(args.seed)

    def w(*shape):
        return (0.02 * torch.randn(*shape, generator=g, device="cuda")).to(
            torch.bfloat16).cpu()
    sd = {"model.embed_tokens.weight": w(32000, 4096),
          "model.norm.weight": w(4096), "lm_head.weight": w(32000, 4096)}
    for i in range(args.layers):
        h = f"model.layers.{i}."
        sd[h + "input_layernorm.weight"] = w(4096)
        sd[h + "post_attention_layernorm.weight"] = w(4096)
        for n in "qkvo":
            sd[h + f"self_attn.{n}_proj.weight"] = w(4096, 4096)
        sd[h + "mlp.gate_proj.weight"] = w(11008, 4096)
        sd[h + "mlp.up_proj.weight"] = w(11008, 4096)
        sd[h + "mlp.down_proj.weight"] = w(4096, 11008)
    nbytes = sum(t.numel() * t.element_size() for t in sd.values())
    with tempfile.TemporaryDirectory() as tmp:
        path = args.dir or os.path.join(tmp, "llama")
        _, write_s = _timed(lambda: save_hf_dir(path, cfg, sd, shards=2))
        del sd
        mapped, map_s = _timed(lambda: load_hf_state_dict(path))
        _, touch_s = _timed(lambda: [t.clone() for t in mapped.values()])
        dev, h2d_mapped_s = _timed(
            lambda: [t.to("cuda") for t in mapped.values()])
        del dev, mapped
        dev, h2d_pinned_s = _timed(lambda: _pinned_reads(path))
        del dev
        _, from_hf_s = _timed(lambda: from_hf(path))
        eng, engine_s = _timed(lambda: deepspeed_tpu_torch.init_inference(
            path, dtype="float32", kv_cache_dtype="float32"))
        _, set_params_s = _timed(lambda: eng.set_params(from_hf(path)[1]))
        del eng
    steps = {"write_s": write_s, "map_s": map_s, "touch_s": touch_s,
             "h2d_mapped_s": h2d_mapped_s, "h2d_pinned_s": h2d_pinned_s,
             "from_hf_s": from_hf_s, "engine_s": engine_s,
             "set_params_s": set_params_s}
    print(json.dumps({
        "model": f"llama2-7b width, {args.layers} of 32 layers, bf16",
        "bytes": nbytes, **steps,
        **{k[:-2] + "_gb_per_s": nbytes / v / 1e9 for k, v in steps.items()
           if k not in ("map_s", "from_hf_s")},
        "reads": "warm (just written, in the page cache)", "gpu": smi,
        "torch": torch.__version__}))


if __name__ == "__main__":
    main()
