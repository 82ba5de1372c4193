"""Writes tests/fixtures/orbax_tiny/ with the JAX package's save_orbax.

    JAX_PLATFORMS=cpu python tests/fixtures/make_orbax_tiny.py

`arrays()` draws the checkpoint's leaves from a fixed seed with numpy alone,
so that a reader without JAX (the port's tests, chip_smoke.py phase 79)
can make them again and hold what it loads to them bit for bit.  The
leaves named in BF16 are stored as bfloat16; arrays() gives them as the
float32 values they hold exactly (the low 16 bits of each cleared).
"""

import os

import numpy as np

SEED = 22
BF16 = ("emb",)
DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "orbax_tiny")


def arrays() -> dict:
    rng = np.random.default_rng(SEED)
    emb = rng.standard_normal((12, 8)).astype(np.float32)
    emb = (emb.view(np.uint32) & np.uint32(0xFFFF0000)).view(np.float32)
    return {
        "emb": emb,
        "layers": [
            {"w": rng.standard_normal((8, 8)).astype(np.float32),
             "q": rng.integers(-127, 128, (8, 4), dtype=np.int8)},
            {"w": rng.standard_normal((8, 8)).astype(np.float32),
             "q": rng.integers(-127, 128, (8, 4), dtype=np.int8)},
        ],
        "norm": rng.standard_normal((8,)).astype(np.float16),
        "ids": rng.integers(0, 1000, (5,), dtype=np.int32),
        "mask": rng.random(6) < 0.5,
        "scale": np.float32(rng.standard_normal()),
        "step": 7,
    }


def main() -> None:
    import jax
    import jax.numpy as jnp

    from kfunca_tpu.utils.checkpoint import save_orbax

    def to_jax(path, x):
        if isinstance(x, int):
            return x
        name = jax.tree_util.keystr(path)
        bf16 = any(f"'{b}'" in name for b in BF16)
        return jnp.asarray(x, dtype=jnp.bfloat16 if bf16 else None)

    tree = jax.tree_util.tree_map_with_path(to_jax, arrays())
    save_orbax(DIR, tree)


if __name__ == "__main__":
    main()
