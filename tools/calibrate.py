"""Memory-bandwidth calibration ladder on the device.

Measures what plain XLA programs reach on device-resident synthetic arrays at
SF10 lineitem width (~60M rows), so a query's bandwidth can be read against
the same call's own ceiling beside the published peak:

  sum1        — jnp.sum over 1 column            (pure reduce read)
  q6_xla      — the Q6 shape: 4 columns read, 3-predicate mask,
                sum(price*disc*mask) + count     (XLA lowering)
  copy        — x + 1.0 materialized             (read+write streaming bound)

All f32/i32, jit-compiled, timed after a warm run with block_until_ready.

    python tools/calibrate.py [rows_millions]   # default 60 (SF10)

Prints one JSON line: {"ceiling_gbps": ..., per-test: {gbps, ms}}.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np


def timed(fn, *args, reps=20):
    """Seconds per execution: pipelined re-issues, then block_until_ready."""
    jax.block_until_ready(fn(*args))  # compile + warm
    t0 = time.perf_counter()
    out = None
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps


def main():
    mrows = float(sys.argv[1]) if len(sys.argv) > 1 else 60.0
    n = int(mrows * 1e6)
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"calibrate.py measures a GPU; JAX's first device is "
                 f"{dev.platform}")
    print(f"device={dev.device_kind} rows={n}", file=sys.stderr, flush=True)

    rng = np.random.default_rng(0)
    qty = jnp.asarray(rng.uniform(1, 50, n).astype(np.float32))
    price = jnp.asarray(rng.uniform(900, 105000, n).astype(np.float32))
    disc = jnp.asarray(rng.uniform(0, 0.1, n).astype(np.float32))
    sdate = jnp.asarray(rng.integers(8000, 11000, n).astype(np.int32))

    res = {"rows": n, "device": dev.device_kind}

    # 1. pure single-column reduce
    f_sum = jax.jit(lambda x: jnp.sum(x, dtype=jnp.float32))
    t = timed(f_sum, price)
    res["sum1"] = {"ms": round(t * 1e3, 3), "gbps": round(4 * n / t / 1e9, 1)}

    # 2. Q6 shape: 4 cols read, 3 predicates, masked product-sum + count
    def q6(q, p, d, s):
        m = (s >= 8766) & (s < 9131) & (d >= 0.05) & (d <= 0.07) & (q < 24)
        mf = m.astype(jnp.float32)
        return jnp.sum(p * d * mf), jnp.sum(mf)

    f_q6 = jax.jit(q6)
    t = timed(f_q6, qty, price, disc, sdate)
    res["q6_xla"] = {"ms": round(t * 1e3, 3),
                     "gbps": round(16 * n / t / 1e9, 1)}

    # 3. streaming copy (read+write)
    f_copy = jax.jit(lambda x: x + 1.0)
    t = timed(f_copy, price, reps=10)
    res["copy"] = {"ms": round(t * 1e3, 3), "gbps": round(8 * n / t / 1e9, 1)}

    ceiling = max(v.get("gbps", 0) for v in res.values()
                  if isinstance(v, dict))
    res["ceiling_gbps"] = ceiling
    print(json.dumps(res))


if __name__ == "__main__":
    main()
