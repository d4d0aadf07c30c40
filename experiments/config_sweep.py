"""Device launch-rate sweep across the main config classes (dense and
gather geometries), timed as the slope between two scan lengths."""
import functools, time
import numpy as np, jax, jax.numpy as jnp
from jax import lax
from speex_resampler_tpu.ops import filter_design as fd
from speex_resampler_tpu.parallel.batch import _launch_geometry, make_batched_step
import math

B = 2048
CONFIGS = [
    ("44.1k->48k q7 (flagship)", 44100, 48000, 7),
    ("24k->48k q5 (integer up)", 24000, 48000, 5),
    ("48k->44.1k q10 (cubic inverse)", 48000, 44100, 10),
    ("48k->8k q4 (6x decimation)", 48000, 8000, 4),
]

for name, ir, orr, q in CONFIGS:
    g = math.gcd(ir, orr)
    spec = fd.design_filter(ir // g, orr // g, q)
    bspec = _launch_geometry(spec, 9408)
    bstep = make_batched_step(spec, bspec)
    step, w = bstep.fn, bstep.w
    rng = np.random.default_rng(0)
    x_np = np.zeros((bstep.chunk_rows, B), dtype=np.int16)
    x_np[:bspec.in_per_launch] = (rng.integers(
        -32768, 32768, size=(bspec.in_per_launch, B)) // 2).astype(np.int16)
    x = jnp.asarray(x_np)
    hist0 = jnp.zeros((bstep.hist_rows, B), dtype=jnp.int16)

    @functools.partial(jax.jit, static_argnames=("iters",))
    def rep(hist, x, w, salt, iters, step=step):
        def body(carry, _):
            h, chk = carry
            hs = h.at[0, :].add((chk + salt).astype(jnp.int16))
            h2, y = step(hs, x, w)
            return (h2, chk + y[0, 0].astype(jnp.int32)), None
        (h, chk), _ = lax.scan(body, (hist, jnp.int32(0)), length=iters)
        return chk

    try:
        for it in (4, 24):
            jax.device_get(rep(hist0, x, w, jnp.int16(99), it))
        ts = {}
        for it in (4, 24):
            best = 9e9
            for i in range(3):
                t0 = time.perf_counter()
                jax.device_get(rep(hist0, x, w, jnp.int16(i), it))
                best = min(best, time.perf_counter() - t0)
            ts[it] = best
        sl = (ts[24] - ts[4]) / 20
        outs = bspec.out_per_launch * B
        ins = bspec.in_per_launch * B
        print(f"{name} [{bspec.kernel}]: {sl*1e3:.3f} ms/launch  "
              f"out {outs/sl/1e9:.1f} G/s  in {ins/sl/1e9:.1f} G/s",
              flush=True)
    except Exception as e:  # noqa: BLE001
        print(f"{name}: FAILED {type(e).__name__}: {e}", flush=True)
