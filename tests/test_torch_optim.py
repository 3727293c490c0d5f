"""The port's optimizers (`repro_torch.optim`) against the reference's
(`repro.optim`), on the CPU.

Five updates of each optimizer from the same params and grads (numpy
draws), on a float32 tree and on a bfloat16 one.  Tolerance: bit for bit,
params and states alike.  Both packages evaluate the update op by op (the
reference eagerly, as a test calls it): a Python float meets a tensor as
a weakly typed scalar in the tensor's dtype, the moments are float32,
AdamW's 1 − β^t is the C library's `powf` (what XLA lowers a float32
power to) and its square root is correctly rounded on both sides.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import make_optimizer as j_make
from repro_torch import convert, tree
from repro_torch.optim import make_optimizer as t_make

@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread for the port's side: these models are tiny,
    and many threads per worker only contend with the suite's other
    workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


OPTIMIZERS = {"sgd": {}, "momentum": {"beta": 0.9},
              "adamw": {"weight_decay": 0.1}}


def _draw(rng, dtype):
    t = {"a": rng.normal(size=(3, 4)), "b": {"c": rng.normal(size=(5,)) * 3,
                                           "d": rng.normal(size=(2, 2, 2))}}
    return jax.tree.map(lambda x: jnp.asarray(x, jnp.float32).astype(dtype),
                        t)


def _bits(x):
    a = np.asarray(convert.to_numpy({"x": x})["x"]) if torch.is_tensor(x) \
        else np.asarray(x)
    return a.view(np.int16 if a.dtype.itemsize == 2 else np.int32) \
        if a.dtype.kind == "f" or a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_updates_match_the_reference_bitwise(name, dtype):
    rng = np.random.default_rng(3)
    jopt = j_make(name, 0.03, **OPTIMIZERS[name])
    topt = t_make(name, 0.03, **OPTIMIZERS[name])
    jp = _draw(rng, jnp.dtype(dtype))
    tp = convert.to_torch(jp)
    js, ts = jopt.init(jp), topt.init(tp)
    for _ in range(5):
        g = _draw(rng, jnp.dtype(dtype))
        jp, js = jopt.update(jp, g, js)
        tp, ts = topt.update(tp, convert.to_torch(g), ts)
        for a, b in zip(jax.tree.leaves((jp, js)), tree.leaves(
                {"p": tp, "s": ts if isinstance(ts, dict) else {}})):
            assert b.dtype == convert.to_torch({"x": a})["x"].dtype
            np.testing.assert_array_equal(_bits(b), _bits(a))
    if name == "adamw":
        assert int(ts["t"]) == int(js["t"]) == 5


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizers_descend_quadratic(name):
    opt = t_make(name, lr=0.1)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = opt.init(params)
    for _ in range(200):
        g = tree.map(lambda w: 2 * w, params)
        params, state = opt.update(params, g, state)
    assert float(params["w"].abs().max()) < 1e-2


def test_unknown_optimizer_raises():
    with pytest.raises(ValueError, match="unknown optimizer"):
        t_make("lion", 0.1)
