"""Accuracy study: custom bf16 multi-pass dot schemes vs f32 HIGHEST.

x is int16, so x = x_hi + x_lo with BOTH parts exactly representable in
bf16 (top 8 / bottom 8 bits).  w is f32 and needs a 2- or 3-term bf16
split.  Schemes (bf16 products, f32 accumulation, like a bf16 tensor-core
pass; the candidate behind lax.DotAlgorithmPreset.BF16_BF16_F32_X3):
  split4: (w_hi + w_lo) x (x_hi + x_lo)                    4 passes
  split5: split6 minus the w_lo*x_lo term                  5 passes
  split6: (w_hi + w_mid + w_lo) x (x_hi + x_lo)            6 passes
Reference: float64 dot; production: f32 (HIGHEST ~ near-f32-exact).
Reports max err and WORD2INT mismatch rate vs the f64 ground truth.
"""
import numpy as np
import jax.numpy as jnp

rng = np.random.default_rng(0)

from speex_resampler_tpu.ops import filter_design as fd
from speex_resampler_tpu.ops import phase as ph

spec = fd.design_filter(147, 160, 7)
W = ph.build_padded_weights(spec.phase_table, 147, 160, 0)[None]  # [1, K, R]
P, K, R = W.shape
print("K,R =", K, R, " L1(w row) ~", np.abs(W[0]).sum(0).mean())

def bf16(a):
    return a.astype(jnp.bfloat16).astype(np.float32)

def word2int(x):
    y = np.floor(0.5 + x)
    y = np.where(x < -32767.5, -32768.0, y)
    y = np.where(x > 32766.5, 32767.0, y)
    return y.astype(np.int16)

B = 4096
x = (rng.integers(-32768, 32768, size=(K, B)) // 2).astype(np.int16)
xf = x.astype(np.float32)
x_lo = (x - ((x.astype(np.int32) >> 8) << 8)).astype(np.float32)   # [0,255]
x_hi = xf - x_lo                                                   # mult of 256

stats = {}
for m in range(P):
    w = W[m].T.astype(np.float32)          # [R, K]
    w_hi = bf16(w)
    w_mid = bf16(w - w_hi)
    w_lo = bf16(w - w_hi - w_mid)
    exact = w.astype(np.float64) @ x.astype(np.float64)
    f32 = (w @ xf).astype(np.float64)
    def acc(*terms):
        s = np.zeros((R, B), np.float32)
        for (a, b) in terms:
            s += bf16(a) @ b   # bf16 x bf16 exact product, f32 accum
        return s.astype(np.float64)
    s6 = acc((w_hi, x_hi), (w_hi, x_lo), (w_mid, x_hi), (w_mid, x_lo),
             (w_lo, x_hi), (w_lo, x_lo))
    s5 = acc((w_hi, x_hi), (w_hi, x_lo), (w_mid, x_hi), (w_mid, x_lo),
             (w_lo, x_hi))
    s4 = acc((w_hi, x_hi), (w_hi, x_lo), (w_mid, x_hi), (w_mid, x_lo))
    s1 = (bf16(w) @ bf16(xf)).astype(np.float64)
    gi = word2int(exact)
    for name, v in [("f32", f32), ("split6", s6), ("split5", s5),
                    ("split4", s4), ("bf16x1", s1)]:
        d = np.abs(v - exact)
        mi = word2int(v)
        mm = (mi != gi).mean()
        mx = np.abs(mi.astype(np.int32) - gi.astype(np.int32)).max()
        st = stats.setdefault(name, [0.0, 0.0, 0.0])
        st[0] = max(st[0], d.max()); st[1] += mm / P; st[2] = max(st[2], mx)

for name, (emax, mm, lsb) in stats.items():
    print(f"{name:8s} max|err|={emax:10.5f}  WORD2INT mismatch={mm:9.6f}  max LSB diff={lsb}")
