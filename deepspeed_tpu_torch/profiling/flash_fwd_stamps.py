"""Where the bf16 flash forward's consumer spends its clock cycles.

    python -m deepspeed_tpu_torch.profiling.flash_fwd_stamps

The card's profilers (ncu, nsys) do not run on the machine this repo is
measured on, so this builds an instrumented copy of the forward: the
sources of ``ops/attention/csrc`` are copied into ``build/flash_fwd_stamps``
and ``clock64()`` stamps are added after each step of thread 0's loop
(waiting for K, issuing the scores, waiting for V, issuing P.V, waiting
for the scores, the softmax, waiting for P.V, the rescale and packing),
summed per block and added into a device counter. One forward per shape
then gives cycles per key tile for each step and, per block, the set-up
(barrier init to Q landed), the last P.V and the epilogue. Thread 0's
cycles are elapsed time on its SM, shared with the other block there, so
the steps read as where one warp waits, not as issue slots. The copy
and its library are never used by the package. Prints one JSON object
per shape, after the card's name and power limit. Needs a CUDA device
and nvcc.
"""

import ctypes
import json
import os
import shutil
import subprocess

import torch

# the consumer's statements to stamp after, and the step each closes
STEPS = (("mbar_wait(q_full, 0);", "setup"),
         ("mbar_wait(&k_full[st], phase);", "wait_k"),
         ("issue_scores(st);", "issue_s"),
         ("mbar_wait(&v_full[prev], prev_phase);", "wait_v"),
         ("issue_pv(prev);", "issue_pv"),
         ("wg_wait<1>();", "wait_s"),
         ("softmax(k0, alpha);", "softmax"),
         ("wg_wait<0>();", "wait_pv"),
         ("rescale_and_pack(alpha);", "rescale"))
NAMES = [n for _, n in STEPS] + ["last_pv", "epilogue", "tiles", "blocks"]
SHAPES = (("a gpt2-small train", 8, 1024, 12, 64),
          ("b long", 1, 4096, 12, 64),
          ("e llama2-7b heads", 1, 2048, 32, 128),
          ("b32 l512 d128", 32, 512, 32, 128))


def _stamp(name):
    i = NAMES.index(name)
    return (f"if (stamp_) {{ const long long n_ = clock64(); "
            f"stamp_acc_[{i}] += n_ - stamp_t_; stamp_t_ = n_; }}")


def instrument(src):
    """The forward kernel's source with the stamps added."""
    lines, out, inside, stored = src.split("\n"), [], False, False
    for ln in lines:
        code = ln.strip()
        if "flash_fwd_wgmma_kernel(const __grid_constant__" in ln:
            inside = True
        if inside and stored and ln == "}":       # the kernel's last line
            inside = False
            out += ["  " + _stamp("epilogue"),
                    f"  if (stamp_) {{ stamp_acc_[{NAMES.index('blocks')}]"
                    " = 1; for (int i_ = 0; i_ < "
                    f"{len(NAMES)}; ++i_) atomicAdd(&g_flash_stamps[i_], "
                    "stamp_acc_[i_]); }"]
        if inside and code == "bf16* out = static_cast<bf16*>(p.o);":
            out.append(_stamp("last_pv"))
        if inside and code.startswith("mbar_wait(&k_full[st], phase);"):
            out.append(_stamp("rescale"))   # the loop's own overhead
        out.append(ln)
        if not inside:
            continue
        if code == "__syncthreads();" and not any(
                "stamp_" in x for x in out):
            out.append("  const bool stamp_ = threadIdx.x == 0; "
                       "long long stamp_t_ = clock64(); "
                       f"unsigned long long stamp_acc_[{len(NAMES)}] = {{}};")
        for stmt, name in STEPS:
            if code.startswith(stmt):
                out.append(_stamp(name))
                if name == "rescale":
                    out.append(f"if (stamp_) stamp_acc_["
                               f"{NAMES.index('tiles')}] += 1;")
        if code.startswith("if (c == 0) p.lse["):
            stored = True
    text = "\n".join(out)
    missing = [n for n in NAMES[:-4] if f"stamp_acc_[{NAMES.index(n)}]"
               not in text]
    if missing or "g_flash_stamps[i_]" not in text:
        raise RuntimeError(f"flash_fwd_stamps: the kernel's source no "
                           f"longer has the statements for {missing}")
    return text.replace(
        "namespace hw {",
        f"__device__ unsigned long long g_flash_stamps[{len(NAMES)}];\n"
        "namespace hw {", 1)


def build():
    from deepspeed_tpu_torch.ops import op_builder as ob
    src_dir = os.path.dirname(ob.FlashAttentionBuilder().source_path())
    dst = os.path.join(ob.BUILD_DIR, "flash_fwd_stamps")
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
extern "C" int flash_stamps(unsigned long long* out) {{
  unsigned long long zero[{len(NAMES)}] = {{}};
  cudaError_t e = cudaMemcpyFromSymbol(out, g_flash_stamps, sizeof(zero));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_flash_stamps, zero,
                                               sizeof(zero));
  return (int)e;
}}
""")
    so = os.path.join(dst, "libflash_stamps.so")
    subprocess.run([ob.find_nvcc(), *ob.NVCC_FLAGS, "-o", so, entry],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(so)
    ob.FlashAttentionBuilder()._annotate(lib)
    lib.flash_stamps.argtypes = [ctypes.c_void_p]
    lib.flash_stamps.restype = ctypes.c_int
    return lib


def main():
    if not torch.cuda.is_available():
        raise SystemExit("flash_fwd_stamps: no CUDA device")
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
    buf = (ctypes.c_ulonglong * len(NAMES))()
    dev = torch.device("cuda")
    try:
        for name, b, l, h, d in SHAPES:
            g = torch.Generator(device=dev).manual_seed(0)
            q, k, v = (torch.randn(b, l, h, d, generator=g, device=dev)
                       .to(torch.bfloat16) for _ in range(3))
            fl.flash_fwd(q, k, v)                 # warm-up
            torch.cuda.synchronize()
            if lib.flash_stamps(ctypes.addressof(buf)):
                raise RuntimeError("flash_stamps failed")
            fl.flash_fwd(q, k, v)
            torch.cuda.synchronize()
            if lib.flash_stamps(ctypes.addressof(buf)):
                raise RuntimeError("flash_stamps failed")
            vals = dict(zip(NAMES, buf))
            tiles, blocks = max(vals["tiles"], 1), max(vals["blocks"], 1)
            print(json.dumps({
                "shape": name, "batch": b, "len": l, "heads": h,
                "head_dim": d, "blocks": blocks,
                "tiles_per_block": tiles / blocks,
                "cycles_per_tile": {n: vals[n] / tiles for _, n in STEPS
                                    if n != "setup"},
                "cycles_per_block": {n: vals[n] / blocks for n in
                                     ("setup", "last_pv", "epilogue")}}),
                flush=True)
    finally:
        if saved is None:
            ob.CUDAOpBuilder._loaded.pop("flash_attention", None)
        else:
            ob.CUDAOpBuilder._loaded["flash_attention"] = saved


if __name__ == "__main__":
    main()
