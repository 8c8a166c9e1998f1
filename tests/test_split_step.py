"""Split-dispatch step (huge-N watchdog-safe path) == single-dispatch step."""

import numpy as np

from nbodyax.physics.step import PhysicsParams, make_split_step, make_step
from nbodyax.state import make_state


def test_split_step_matches_monolithic(kernel_interpreter):
    rng = np.random.RandomState(2)
    n = 300
    st = make_state(rng.uniform(-1000, 1000, (n, 2)).astype(np.float32),
                    rng.uniform(-2, 2, (n, 2)).astype(np.float32),
                    rng.uniform(1, 100, n).astype(np.float32),
                    rng.uniform(5, 30, n).astype(np.float32))
    p = PhysicsParams(dt=0.1, field_width=1000, field_height=1000)
    mono = make_step(p)
    split = make_split_step(p, n_splits=4, tile_i=32, tile_j=128)
    a, b = st, st
    for _ in range(3):
        a = split(a)
        b = mono(b)
    np.testing.assert_allclose(np.asarray(a.pos), np.asarray(b.pos),
                               rtol=1e-5, atol=1e-3)
    np.testing.assert_array_equal(np.asarray(a.mass) > 0,
                                  np.asarray(b.mass) > 0)
    assert int(np.asarray(a.step)) == 3


def test_split_step_leapfrog_matches_monolithic(kernel_interpreter):
    rng = np.random.RandomState(3)
    n = 300
    st = make_state(rng.uniform(-1000, 1000, (n, 2)).astype(np.float32),
                    rng.uniform(-2, 2, (n, 2)).astype(np.float32),
                    rng.uniform(1, 100, n).astype(np.float32),
                    rng.uniform(5, 30, n).astype(np.float32))
    p = PhysicsParams(dt=0.1, field_width=1000, field_height=1000,
                      integrator="leapfrog")
    mono = make_step(p)
    split = make_split_step(p, n_splits=4, tile_i=32, tile_j=128)
    a, b = st, st
    for _ in range(3):
        a = split(a)
        b = mono(b)
    np.testing.assert_allclose(np.asarray(a.pos), np.asarray(b.pos),
                               rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(np.asarray(a.vel), np.asarray(b.vel),
                               rtol=1e-5, atol=1e-3)
    np.testing.assert_array_equal(np.asarray(a.mass) > 0,
                                  np.asarray(b.mass) > 0)
    assert int(np.asarray(a.step)) == 3
