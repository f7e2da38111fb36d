"""What the per-row and mean readings of phase 4i's flash forward check
(``chip_smoke.row_and_mean_errs``) give for the kernel's own rounding
and for planted faults, through the plain math on the CPU at
deepseek_coder_33b's row length (t 4096, hd 128, bf16; 2 heads, seeded
normal q, k, v).

The reference is the causal softmax in f32 rounded to bf16 once.  "P
rounded to bf16" rounds the probabilities before the PV product, as the
tensor-core kernel does; the other rows leave keys out of some rows or
let a row see one key past the diagonal.

    python scripts/flash_row_errors.py
"""
from __future__ import annotations

import math

import torch

H, T, HD = 2, 4096, 128


def main() -> None:
    torch.manual_seed(0)
    q, k, v = (torch.randn(1, H, T, HD).bfloat16() for _ in range(3))
    s = (q.float() @ k.float().transpose(-1, -2)) / math.sqrt(HD)
    causal = torch.ones(T, T, dtype=torch.bool).tril()

    def attn(mask, p_bf16=False):
        x = s.masked_fill(~mask, float("-inf"))
        p = torch.exp(x - x.amax(-1, keepdim=True))
        pv = p.bfloat16().float() if p_bf16 else p
        return ((pv @ v.float()) / p.sum(-1, keepdim=True)).bfloat16()

    ref = attn(causal)

    def read(o, label):
        err, mag = (o.float() - ref.float()).abs(), ref.float().abs()
        row = (err.amax(-1) / mag.amax(-1)).amax().item()
        mean = (err.mean() / mag.mean()).item()
        print(f"{label}: max over rows of max|err| / max|ref| {row:.3e}; "
              f"mean|err| / mean|ref| {mean:.3e}; max abs {err.max():.3e}")

    read(attn(causal, p_bf16=True), "P rounded to bf16")
    for tile in (64, 128):
        m = causal.clone()
        m[:, 2048:2048 + tile] = False
        m[torch.arange(T), torch.arange(T)] = True
        read(attn(m), f"keys 2048..{2047 + tile} left out of every row")
    read(attn(torch.ones(T, T, dtype=torch.bool).tril(1)),
         "one key past the diagonal seen")
    m = causal.clone()
    m[3000:, 1024:1088] = False
    read(attn(m), "keys 1024..1087 left out of rows >= 3000")


if __name__ == "__main__":
    main()
