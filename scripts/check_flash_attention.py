#!/usr/bin/env python3
"""The attention kernels C7, C8 and C9 (csrc/flash_attention.cu and
csrc/flash_attention_bwd.cu) alone on one CUDA GPU: what ptxas says of them
(registers, shared memory, spills), then ``chip_smoke.py``'s own cases
(``flash_case``, ``flash_bwd_case``) at more shapes than the smoke run
takes, with the rate each kernel reaches, and a fingerprint of C8's
outputs (sha256 of dk and dv, from the plain version's o and lse so that
C7 does not enter it) to compare two trees' C8 bit for bit.

    python3 scripts/check_flash_attention.py [OUT_DIR]

Writes ``OUT_DIR/flash_attention_ptxas.txt`` (default ``build/profile``)
and prints one line per kernel and shape. Exits non-zero if a kernel does
not build, launch or agree.
"""
from __future__ import annotations

import hashlib
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from chip_smoke import (FLASH_EDGE_CASES, flash_bwd_case,  # noqa: E402
                        flash_case)
from deformationpyramid_tpu_torch.ops import cuda_lib  # noqa: E402

# L, S, src_len, heads, head width
TIMED_SHAPES = ((2048, 2048, 1500, 4, 132), (1024, 1024, 900, 4, 132),
                (4096, 4096, 2836, 4, 132), (4096, 4096, 4096, 4, 132))


def c8_fingerprint(dev, L, S, n, h, d) -> str:
    """sha256 of C8's inputs lse and delta and of its dk and dv, on
    chip_smoke.py's inputs of this shape."""
    from deformationpyramid_tpu_torch.match import attention as att

    gen = torch.Generator().manual_seed(0)
    q, k, v, do = (torch.randn(m, h, d, generator=gen).to(dev)
                   for m in (L, S, S, L))
    n_valid = torch.tensor(n, dtype=torch.int32, device=dev)
    scale = d ** -0.5
    o, lse = att.flash_attention_plain(q, k, v, n_valid, scale,
                                       return_lse=True)
    delta = (do * o).sum(-1)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    att.FLASH_ATTENTION_BWD_DKV.launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), n_valid.data_ptr(), L, S, h, d,
        scale, dk.data_ptr(), dv.data_ptr())
    torch.cuda.synchronize()

    def sha(*ts):
        digest = hashlib.sha256()
        for t in ts:
            digest.update(t.cpu().numpy().tobytes())
        return digest.hexdigest()[:16]
    return f"lse, delta {sha(lse, delta)}; dk, dv {sha(dk, dv)}"


def main():
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    out = Path(sys.argv[1]) if len(sys.argv) > 1 else REPO / "build/profile"
    out.mkdir(parents=True, exist_ok=True)
    logs = []
    for name in ("flash_attention.cu", "flash_attention_bwd.cu"):
        log = subprocess.run(
            [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-Xptxas", "-v", "-I",
             str(cuda_lib.CSRC), "-c", str(cuda_lib.CSRC / name), "-o",
             "/dev/null"], capture_output=True, text=True)
        logs.append(log.stdout + log.stderr)
        print(log.stderr.strip()[-2500:], flush=True)
        if log.returncode != 0:
            raise RuntimeError(f"{name} does not compile")
    (out / "flash_attention_ptxas.txt").write_text("\n".join(logs))
    _, secs = cuda_lib.build()
    print(f"build {secs:.1f} s", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    for i, shape in enumerate(FLASH_EDGE_CASES):
        flash_case(dev, seed=i, timed=False, **shape)
        flash_bwd_case(dev, seed=i, timed=False, **shape)
        flash_bwd_case(dev, seed=i, timed=False, nan_pad=True, **shape)
    for L, S, n, h, d in TIMED_SHAPES:
        print(f"C8 fingerprint [L {L}, S {S}, src_len {n}, {h} heads of "
              f"{d}]: {c8_fingerprint(dev, L, S, n, h, d)}", flush=True)
    for L, S, n, h, d in TIMED_SHAPES:
        ops = L * n * h * d / 1e9
        fwd = flash_case(dev, L, S, n, h, d, seed=0, timed=True)
        bwd = flash_bwd_case(dev, L, S, n, h, d, seed=0, timed=True)
        print(f"  TFLOP/s: C7 {4.0 * ops / fwd['ms']:.2f}, C8 "
              f"{6.0 * ops / bwd['flash_attention_bwd_dkv']['ms']:.2f}, C9 "
              f"{4.0 * ops / bwd['flash_attention_bwd_dq']['ms']:.2f}",
              flush=True)


if __name__ == "__main__":
    main()
