#!/usr/bin/env python3
"""Times the streamed-attention kernels C7 and C9 built from other copies
of their sources, on one CUDA GPU: for comparing variants of
``flash_attention.cu``, ``flash_attention_bwd.cu`` and ``tf32_mma.cuh`` in
one call.

    python3 scripts/time_flash_variants.py DIR [DIR ...]

Each DIR holds those three files (a copy of ``deformationpyramid_tpu_torch/
csrc`` with an edit, say); all of them are built at once, each alone into
``DIR/build`` with the package's own nvcc flags
(``cuda_lib.build_variants``), and bound through this tree's wrappers, so
the C entry points must keep their signatures. For each DIR and for L = S = 4096
(2836 valid) and 1024 (900 valid), 4 heads of 132, it prints the device
time of C7 and of C9 (``chip_smoke.cuda_ms``) and the max abs error of o,
lse and dq against the plain versions.
"""
from __future__ import annotations

import sys
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
    dirs = [Path(d).resolve() for d in sys.argv[1:]]
    print(f"built {len(dirs)} variants in "
          f"{cuda_lib.build_variants(dirs):.1f} s", flush=True)
    for src in dirs:
        cuda_lib.use_variant(src)
        line = f"{src.name:14s}"
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
