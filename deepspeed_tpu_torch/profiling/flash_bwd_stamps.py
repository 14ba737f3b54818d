"""Where the bf16 flash backward's consumers spend their clock cycles.

    python -m deepspeed_tpu_torch.profiling.flash_bwd_stamps

The card's profilers (ncu, nsys) do not run on the machine this repo is
measured on, so this builds an instrumented copy of the backward pair
(``flash_bwd_wgmma``, the body of both the dq and the dkv kernel): the
sources of ``ops/attention/csrc`` are copied into
``build/flash_bwd_stamps`` and ``clock64()`` stamps are added after each
step of thread 0's loop (waiting for the stage, issuing the score-side
products, waiting for them, making p and ds and packing them to bf16,
issuing the gradient products, waiting for them, releasing the stage), summed per
block and added into a device counter per kernel. One backward per shape
then gives, for each kernel, cycles per walked tile for each step and,
per block, the set-up (barrier init to the own tiles landed) and the
epilogue (the stores). Thread 0's cycles are elapsed time on its SM,
shared with the other blocks there, so the steps read as where one warp
waits, not as issue slots. The copy and its library are never used by
the package. Prints one JSON object per shape, after the card's name and
power limit. Needs a CUDA device and nvcc.
"""

import ctypes
import json
import os
import shutil
import subprocess

import torch

# the consumer's statements to stamp after, and the step each closes (the
# body waits on its wgmma groups twice a tile: the scores, then the grads)
STEPS = (("mbar_wait(own_full, 0);", "setup"),
         ("mbar_wait(&full[st], phase);", "wait_tile"),
         ("issue_scores(st);", "issue_s"),
         ("wg_wait<0>();", "wait_s"),
         ("make_p_ds(o0, st);", "p_ds"),
         ("issue_grads(st);", "issue_g"),
         ("wg_wait<0>();", "wait_g"),
         ("mbar_arrive(&empty[st]);", "release"))
NAMES = [n for _, n in STEPS] + ["epilogue", "tiles", "blocks"]
KERNELS = ("flash_bwd_dq", "flash_bwd_dkv")
SHAPES = (("a gpt2-small train", 8, 1024, 12, 64),
          ("b long", 1, 4096, 12, 64),
          ("e llama2-7b heads", 1, 2048, 32, 128))
BODY = "__device__ __forceinline__ void flash_bwd_wgmma("
END = "\n}\n\ntemplate <int D, class Walk>\n__global__ void __launch_bounds__("


def _stamp(name):
    i = NAMES.index(name)
    return (f"if (stamp_) {{ const long long n_ = clock64(); "
            f"stamp_acc_[{i}] += n_ - stamp_t_; stamp_t_ = n_; }}")


def instrument(src):
    """The backward body's source with the stamps added."""
    head, body = src.split(BODY, 1)
    body, tail = body.split(END, 1)
    out, todo = [], list(STEPS)
    for ln in body.split("\n"):
        code = ln.strip()
        out.append(ln)
        if code == "__syncthreads();":
            out.append("  const bool stamp_ = threadIdx.x == 0; "
                       "long long stamp_t_ = clock64(); "
                       f"unsigned long long stamp_acc_[{len(NAMES)}] = {{}};")
        if todo and code == todo[0][0]:
            out.append(_stamp(todo[0][1]))
            if todo[0][1] == "release":
                out.append(f"if (stamp_) stamp_acc_["
                           f"{NAMES.index('tiles')}] += 1;")
            todo.pop(0)
        if code == "mbar_arrive(&empty[st]);":
            # the loop closes here: the next tile's steps start again
            todo = list(STEPS[1:])
    if todo != list(STEPS[1:]):
        raise RuntimeError(f"flash_bwd_stamps: the backward body no longer "
                           f"has the statements for {[n for _, n in todo]}")
    out += ["  " + _stamp("epilogue"),
            f"  if (stamp_) {{ stamp_acc_[{NAMES.index('blocks')}] = 1; "
            f"for (int i_ = 0; i_ < {len(NAMES)}; ++i_) "
            "atomicAdd(&g_bwd_stamps[kKeysOwn ? 1 : 0][i_], "
            "stamp_acc_[i_]); }"]
    text = head + BODY + "\n".join(out) + END + tail
    return text.replace(
        "namespace hw {",
        f"__device__ unsigned long long g_bwd_stamps[2][{len(NAMES)}];\n"
        "namespace hw {", 1)


def build():
    from deepspeed_tpu_torch.ops import op_builder as ob
    src_dir = os.path.dirname(ob.FlashAttentionBuilder().source_path())
    dst = os.path.join(ob.BUILD_DIR, "flash_bwd_stamps")
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(src_dir, dst)
    path = os.path.join(dst, "flash_kernels.cuh")
    with open(path) as f:
        text = instrument(f.read())
    with open(path, "w") as f:
        f.write(text)
    entry = os.path.join(dst, "flash_attention.cu")
    with open(entry, "a") as f:
        f.write(f"""
extern "C" int flash_bwd_stamps(unsigned long long* out) {{
  unsigned long long zero[2 * {len(NAMES)}] = {{}};
  cudaError_t e = cudaMemcpyFromSymbol(out, g_bwd_stamps, sizeof(zero));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_bwd_stamps, zero,
                                               sizeof(zero));
  return (int)e;
}}
""")
    so = os.path.join(dst, "libflash_bwd_stamps.so")
    subprocess.run([ob.find_nvcc(), *ob.NVCC_FLAGS, "-o", so, entry],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(so)
    ob.FlashAttentionBuilder()._annotate(lib)
    lib.flash_bwd_stamps.argtypes = [ctypes.c_void_p]
    lib.flash_bwd_stamps.restype = ctypes.c_int
    return lib


def main():
    if not torch.cuda.is_available():
        raise SystemExit("flash_bwd_stamps: no CUDA device")
    from deepspeed_tpu_torch.ops import op_builder as ob
    from deepspeed_tpu_torch.ops.attention import flash as fl
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"gpu": smi}), flush=True)
    lib = build()
    saved = ob.CUDAOpBuilder._loaded.get("flash_attention")
    ob.CUDAOpBuilder._loaded["flash_attention"] = lib
    buf = (ctypes.c_ulonglong * (2 * len(NAMES)))()
    dev = torch.device("cuda")
    try:
        for name, b, l, h, d in SHAPES:
            g = torch.Generator(device=dev).manual_seed(0)
            q, k, v, do = (torch.randn(b, l, h, d, generator=g, device=dev)
                           .to(torch.bfloat16) for _ in range(4))
            o, lse = fl.flash_fwd(q, k, v)
            fl.flash_bwd(q, k, v, o, lse, do)     # warm-up
            torch.cuda.synchronize()
            if lib.flash_bwd_stamps(ctypes.addressof(buf)):
                raise RuntimeError("flash_bwd_stamps failed")
            fl.flash_bwd(q, k, v, o, lse, do)
            torch.cuda.synchronize()
            if lib.flash_bwd_stamps(ctypes.addressof(buf)):
                raise RuntimeError("flash_bwd_stamps failed")
            out = {"shape": name, "batch": b, "len": l, "heads": h,
                   "head_dim": d}
            for i, kernel in enumerate(KERNELS):
                vals = dict(zip(NAMES, buf[i * len(NAMES):
                                           (i + 1) * len(NAMES)]))
                tiles, blocks = max(vals["tiles"], 1), max(vals["blocks"], 1)
                out[kernel] = {
                    "blocks": blocks, "tiles_per_block": tiles / blocks,
                    "cycles_per_tile": {n: vals[n] / tiles
                                        for _, n in STEPS[1:]},
                    "cycles_per_block": {n: vals[n] / blocks
                                         for n in ("setup", "epilogue")}}
            print(json.dumps(out), flush=True)
    finally:
        if saved is None:
            ob.CUDAOpBuilder._loaded.pop("flash_attention", None)
        else:
            ob.CUDAOpBuilder._loaded["flash_attention"] = saved


if __name__ == "__main__":
    main()
