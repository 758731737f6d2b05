#!/usr/bin/env python3
"""Times the streamed-attention kernels C7 and C9 built from other copies
of their sources, on one CUDA GPU: for comparing variants of
``flash_attention.cu``, ``flash_attention_bwd.cu`` and ``tf32_mma.cuh`` in
one call.

    python3 scripts/time_flash_variants.py DIR [DIR ...]

Each DIR holds those three files (a copy of ``deformationpyramid_tpu_torch/
csrc`` with an edit, say); each is built alone into ``DIR/build`` with the
package's own nvcc flags and bound through this tree's wrappers, so the C
entry points must keep their signatures. For each DIR and for L = S = 4096
(2836 valid) and 1024 (900 valid), 4 heads of 132, it prints the device
time of C7 and of C9 (``chip_smoke.cuda_ms``) and the max abs error of o,
lse and dq against the plain versions.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from chip_smoke import cuda_ms  # noqa: E402
from deformationpyramid_tpu_torch.match import attention as att  # noqa: E402
from deformationpyramid_tpu_torch.ops import cuda_lib  # noqa: E402

# L, S, valid source rows, heads, head width
SHAPES = ((4096, 4096, 2836, 4, 132), (1024, 1024, 900, 4, 132))


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    dev = torch.device("cuda")
    cases = []
    for L, S, n, h, d in SHAPES:
        gen = torch.Generator().manual_seed(0)
        q, k, v, do = (torch.randn(m, h, d, generator=gen).to(dev)
                       for m in (L, S, S, L))
        cases.append((q, k, v, do, torch.tensor(n, dtype=torch.int32,
                                                device=dev), d ** -0.5))
    for src in sys.argv[1:]:
        cuda_lib.CSRC = Path(src).resolve()
        cuda_lib.BUILD_DIR = cuda_lib.CSRC / "build"
        cuda_lib._lib = None
        for kern in (att.FLASH_ATTENTION, att.FLASH_ATTENTION_BWD_DKV,
                     att.FLASH_ATTENTION_BWD_DQ):
            kern._fn = None
        t0 = time.perf_counter()
        cuda_lib.build()
        line = f"{Path(src).name:14s} build {time.perf_counter() - t0:5.1f} s"
        for q, k, v, do, nv, sc in cases:
            L, S, (h, d) = q.shape[0], k.shape[0], q.shape[1:]
            o, lse = att.flash_attention_cuda(q, k, v, nv, sc,
                                              return_lse=True)
            o_ref, lse_ref = att.flash_attention_plain(q, k, v, nv, sc,
                                                       return_lse=True)
            dq = att.flash_attention_bwd_cuda(q, k, v, o, lse, do, nv, sc)[0]
            dq_ref = att.flash_attention_bwd_plain(q, k, v, o_ref, lse_ref,
                                                   do, nv, sc)[0]
            delta = (do * o).sum(-1)
            out = torch.empty_like(q)
            args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                    lse.data_ptr(), delta.data_ptr(), nv.data_ptr(), L, S, h,
                    d, sc, out.data_ptr())
            c7 = cuda_ms(lambda: att.flash_attention_cuda(q, k, v, nv, sc))
            c9 = cuda_ms(lambda: att.FLASH_ATTENTION_BWD_DQ.launch(*args))
            errs = [float((a - b).abs().max()) for a, b in
                    ((o, o_ref), (lse, lse_ref), (dq, dq_ref))]
            line += (f" | L {L}: C7 {c7:.4f} C9 {c9:.4f} ms (err o "
                     f"{errs[0]:.1e} lse {errs[1]:.1e} dq {errs[2]:.1e})")
        print(line, flush=True)


if __name__ == "__main__":
    main()
