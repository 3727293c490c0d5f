"""LLM training in the port against the reference, on the CPU: the
model's loss and gradient for every family, the paper's round
(`core.fed_step.fed_train_step`), the SFL step and `launch.train`.

The same params (the reference's init, carried across with
`convert.to_torch`) and the same numpy batches go through `repro` and
`repro_torch`, at tiny float32 configs (2 layers, d 64, 16 tokens, as
`tests/test_federated.py` trains).  Tolerances and why:

  * loss within 1e-6 relative, every gradient leaf within 5e-6 absolute
    (gradients of magnitude 0.2-0.5; XLA and PyTorch sum matmuls and
    reductions in other orders: readings 0-1.2e-7 and 1.7e-7-8.3e-7);
  * `fed_train_step` against the reference jitted, as its tests run it:
    params within 1e-6 absolute (readings 3.0e-8 and 1.2e-7; the jitted
    reference is 1.5e-8 from its own eager run), node losses within 1e-6
    relative; accuracies, the detection threshold, the mask and n_normal
    equal (the noise is the reference's `jax.random.normal`, bit for
    bit, and the node keys its `jax.random.split`);
  * the SFL step likewise (params within 1e-6, SGD and Momentum).
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro import configs as jconfigs
from repro.checkpointing import load_checkpoint as j_load
from repro.core.fed_step import FedStepConfig as JFed
from repro.data.synthetic import make_token_dataset
from repro.launch import steps as jsteps
from repro.launch.train import make_batches as j_batches
from repro.models import init_params as j_init
from repro.models import loss_fn as j_loss
from repro_torch import configs as tconfigs
from repro_torch import convert, tree
from repro_torch.core.fed_step import FedStepConfig as TFed
from repro_torch.core.fed_step import fed_train_step as t_fed_step
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import init_params as t_init
from repro_torch.models import loss_fn as t_loss

@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread for the port's side: these models are tiny,
    and many threads per worker only contend with the suite's other
    workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TINY = dict(n_layers=2, d_model=64, d_ff=128, vocab=64, attn_chunk=8)
# one config of each family; remat on in four of them
FAMILIES = {
    "dense": ("smollm-360m", dict(n_heads=4, n_kv_heads=2, remat=True)),
    "moe": ("kimi-k2-1t-a32b", dict(remat=True)),
    "ssm": ("falcon-mamba-7b", dict(remat=True)),
    "hybrid": ("zamba2-1.2b", dict(attn_every=2, remat=True)),
    "vlm": ("qwen2-vl-72b", {}),
    "audio": ("whisper-large-v3", dict(n_audio_frames=8, encoder_layers=2)),
}


def _configs(arch, **extra):
    kw = dict(TINY, **extra)
    return (jconfigs.get_smoke_config(arch).replace(**kw),
            tconfigs.get_smoke_config(arch).replace(**kw))


def _torch_batch(b):
    return {k: torch.as_tensor(np.array(v)) for k, v in b.items()}


def _max_err(want_tree, got_tree):
    return max(float(np.abs(np.asarray(a, np.float32)
                            - b.detach().to(torch.float32).numpy()).max())
               for a, b in zip(jax.tree.leaves(want_tree),
                               tree.leaves(got_tree)))


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_loss_and_gradient_match_reference(family):
    arch, extra = FAMILIES[family]
    jc, tc = _configs(arch, **extra)
    pj = j_init(jc, jax.random.PRNGKey(0))
    batch = j_batches(jc, make_token_dataset(0, 64, 16, jc.vocab), (2,), 16,
                      np.random.default_rng(0))
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p, b: j_loss(p, jc, b), has_aux=True))(pj, batch)
    leaves = [x.requires_grad_(True)
              for x in tree.leaves(convert.to_torch(pj))]
    tl, _ = t_loss(tree.unflatten_like(convert.to_torch(pj), leaves), tc,
                   _torch_batch(batch))
    tg = torch.autograd.grad(tl, leaves)
    assert abs(float(tl.detach()) - float(jl)) <= 1e-6 * abs(float(jl))
    for a, g in zip(jax.tree.leaves(jg), tg):
        assert g.shape == a.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(a), rtol=0,
                                   atol=5e-6)


@pytest.mark.parametrize("family", ["audio", "dense", "hybrid", "ssm"])
def test_remat_recomputes_blocks_and_keeps_every_gradient(family,
                                                          monkeypatch):
    """With ``remat`` each block the reference wraps in `jax.checkpoint`
    runs under `torch.utils.checkpoint` (the audio encoder's and
    decoder's blocks, the Mamba blocks, not zamba2's shared block), and
    the gradients are bit for bit those without it."""
    from repro_torch.models import model as tm

    arch, extra = FAMILIES[family]
    _, tc = _configs(arch, **dict(extra, remat=False))
    params = t_init(tc, torch.Generator().manual_seed(0))
    batch = ttrain.make_batches(tc, make_token_dataset(0, 64, 16, tc.vocab),
                                (2,), 16, np.random.default_rng(0))
    calls = []

    def spy(fn, *args, **kw):
        calls.append(kw["use_reentrant"])
        return tm.torch.utils.checkpoint.checkpoint(fn, *args, **kw)

    monkeypatch.setattr(tm, "checkpoint", spy)
    grads = {}
    for remat in (False, True):
        leaves = [x.detach().requires_grad_(True)
                  for x in tree.leaves(params)]
        loss, _ = t_loss(tree.unflatten_like(params, leaves),
                         tc.replace(remat=remat), batch)
        grads[remat] = torch.autograd.grad(loss, leaves)
    blocks = tc.n_layers + (tc.encoder_layers if family == "audio" else 0)
    assert calls == [False] * blocks
    for a, b in zip(grads[False], grads[True]):
        assert torch.equal(a, b)


def _lm_round(local_steps, lr, detect_s, corrupt_node=None, eval_rows=2):
    """A qwen1.5 tiny round's inputs: (configs, reference params, node
    batches, eval batch, FedStepConfig kwargs)."""
    jc, tc = _configs("qwen1.5-0.5b")
    data = make_token_dataset(0, 128, 16, jc.vocab)
    rng = np.random.default_rng(0)
    nb = j_batches(jc, data, (4, local_steps, 4), 16, rng)
    eb = j_batches(jc, data, (eval_rows,), 16, rng)
    nb = {k: np.array(v) for k, v in nb.items()}
    if corrupt_node is not None:         # a node trained on random targets
        nb["targets"][corrupt_node] = rng.integers(
            0, jc.vocab, nb["targets"][corrupt_node].shape)
    fkw = dict(n_nodes=4, local_steps=local_steps, lr=lr, sigma=1e-3,
               detect=True, detect_s=detect_s)
    return jc, tc, j_init(jc, jax.random.PRNGKey(0)), nb, eb, fkw


@pytest.mark.parametrize("case", ["ties", "drops"])
def test_fed_train_step_matches_the_jitted_reference(case):
    """"ties": every node's accuracy ties, so detection keeps all four;
    "drops": node 0 trains on random targets for four steps at lr 0.5 and
    Alg. 2 at s = 50 rejects it and one more node."""
    if case == "ties":
        jc, tc, pj, nb, eb, fkw = _lm_round(2, 0.1, 80.0)
    else:
        jc, tc, pj, nb, eb, fkw = _lm_round(4, 0.5, 50.0, corrupt_node=0,
                                            eval_rows=4)
    key = jax.random.PRNGKey(1)
    step = jax.jit(jsteps.make_step(jc, "fed_train", fcfg=JFed(**fkw)))
    jp, jm = step(pj, jax.tree.map(jnp.asarray, nb),
                  jax.tree.map(jnp.asarray, eb), key)
    tstep = tsteps.make_step(tc, "fed_train", fcfg=TFed(**fkw))
    tp, tm = tstep(convert.to_torch(pj), _torch_batch(nb), _torch_batch(eb),
                   np.asarray(key))
    assert _max_err(jp, tp) <= 1e-6
    np.testing.assert_allclose(tm["node_losses"].numpy(),
                               np.asarray(jm["node_losses"]), rtol=1e-6)
    for k in ("node_accuracies", "detect_threshold", "n_normal"):
        np.testing.assert_array_equal(tm[k].numpy(), np.asarray(jm[k]))
    np.testing.assert_allclose(float(tm["delta_norm_mean"]),
                               float(jm["delta_norm_mean"]), rtol=1e-6)
    if case == "ties":
        assert int(tm["n_normal"]) == 4
        assert len(set(tm["node_accuracies"].tolist())) == 1
    else:
        accs = tm["node_accuracies"]
        assert bool(accs[0] == accs.min())
        assert not bool(accs[0] > tm["detect_threshold"])
        assert 1 <= int(tm["n_normal"]) < 4


def test_fed_step_alpha_one_keeps_global():
    _, tc = _configs("olmo-1b", n_layers=1, d_model=32, d_ff=64, vocab=32)
    params = t_init(tc, torch.Generator().manual_seed(0))
    fcfg = TFed(n_nodes=2, local_steps=1, lr=0.1, sigma=0.0, alpha=1.0,
                detect=False)
    toks = torch.zeros((2, 1, 2, 8), dtype=torch.int32)
    new, m = t_fed_step(params, {"tokens": toks, "targets": toks}, None,
                        np.array([0, 1], np.uint32),
                        loss_fn=lambda p, b: t_loss(p, tc, b), acc_fn=None,
                        fcfg=fcfg)
    for a, b in zip(tree.leaves(new), tree.leaves(params)):
        assert torch.equal(a, b)
    assert int(m["n_normal"]) == 2


@pytest.mark.parametrize("optimizer", ["sgd", "momentum"])
def test_plain_train_step_matches_the_jitted_reference(optimizer):
    """Two SFL steps: `make_step("plain_train")` (SGD) and
    `plain_train_step` with Momentum and its state, whose metrics carry
    the loss's scalar aux (ce, aux, accuracy).  (AdamW divides each grad
    by its own root mean square, so a grad near 0 that the two packages
    sum 1e-9 apart moves its param by up to lr: 1.4e-4 after two steps
    here; `tests/test_torch_optim.py` holds AdamW bit for bit on equal
    grads.)"""
    from repro.core.fed_step import plain_train_step as j_plain
    from repro.optim import Momentum as JMomentum
    from repro_torch.core.fed_step import plain_train_step as t_plain
    from repro_torch.optim import Momentum as TMomentum

    jc, tc = _configs("qwen1.5-0.5b")
    pj = j_init(jc, jax.random.PRNGKey(0))
    batch = j_batches(jc, make_token_dataset(0, 64, 16, jc.vocab), (8,), 16,
                      np.random.default_rng(2))
    if optimizer == "sgd":
        jstep = jax.jit(jsteps.make_step(jc, "plain_train", lr=0.1))
        tstep = tsteps.make_step(tc, "plain_train", lr=0.1)
    else:
        jopt, topt = JMomentum(lr=0.05), TMomentum(lr=0.05)
        js, ts = jopt.init(pj), topt.init(convert.to_torch(pj))

        @jax.jit
        def jstep(p, b, s):
            return j_plain(p, s, b, loss_fn=lambda q, c: j_loss(q, jc, c),
                           optimizer=jopt)
    jp, tp = pj, convert.to_torch(pj)
    for _ in range(2):
        if optimizer == "sgd":
            jp, jl = jstep(jp, batch)
            tp, tl = tstep(tp, _torch_batch(batch))
        else:
            jp, js, jm = jstep(jp, batch, js)
            tp, ts, tm = t_plain(tp, ts, _torch_batch(batch),
                                 loss_fn=lambda q, c: t_loss(q, tc, c),
                                 optimizer=topt)
            assert sorted(tm) == sorted(jm) == ["accuracy", "aux", "ce",
                                                "loss"]
            jl, tl = jm["loss"], tm["loss"]
        assert abs(float(tl) - float(jl)) <= 1e-6 * abs(float(jl))
    assert _max_err(jp, tp) <= 1e-6


def test_use_flash_training_raises():
    _, tc = _configs("smollm-360m", n_heads=4, n_kv_heads=2,
                     use_flash=True)
    params = t_init(tc, torch.Generator().manual_seed(0))
    toks = torch.zeros((1, 1, 2, 16), dtype=torch.int32)
    step = tsteps.make_step(tc, "fed_train",
                            fcfg=TFed(n_nodes=1, local_steps=1, detect=False))
    with pytest.raises(RuntimeError, match="K6.*no backward kernel"):
        step(params, {"tokens": toks, "targets": toks}, None,
             np.array([0, 1], np.uint32))
    with pytest.raises(RuntimeError, match="no backward kernel"):
        tsteps.make_step(tc, "plain_train")(params, {"tokens": toks[0, 0],
                                                     "targets": toks[0, 0]})
    with torch.no_grad():            # scoring with K6 stays allowed
        t_loss(tree.map(lambda p: p.requires_grad_(True), params), tc,
               {"tokens": toks[0, 0], "targets": toks[0, 0]})


@pytest.mark.parametrize("family", ["dense", "vlm", "audio"])
def test_make_batches_draws_the_reference_windows(family):
    arch = FAMILIES[family][0]
    jc, tc = jconfigs.get_smoke_config(arch), tconfigs.get_smoke_config(arch)
    toks = make_token_dataset(1, 20, 17, jc.vocab)
    want = j_batches(jc, toks, (2, 3), 16, np.random.default_rng(4))
    got = ttrain.make_batches(tc, toks, (2, 3), 16, np.random.default_rng(4))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("mode", ["fed", "plain"])
def test_launch_train_runs_on_the_cpu_with_a_checkpoint(mode, tmp_path,
                                                         capsys):
    ck = str(tmp_path / "ck")
    ttrain.main(["--device", "cpu", "--mode", mode, "--rounds", "1",
                 "--nodes", "2", "--local-steps", "1", "--batch", "1",
                 "--seq", "16", "--ckpt", ck])
    out = capsys.readouterr().out
    assert "final eval: loss=" in out and f"checkpoint saved to {ck}" in out
    tc = tconfigs.get_smoke_config("smollm-360m")
    like = t_init(tc, torch.Generator().manual_seed(0))
    jparams, step = j_load(ck, j_init(jconfigs.get_smoke_config(
        "smollm-360m"), jax.random.PRNGKey(0)))     # the reference reads it
    assert step == 1
    assert jax.tree.structure(jparams) == jax.tree.structure(
        jax.tree.map(np.asarray, convert.to_numpy(like)))
    assert all(np.isfinite(np.asarray(x)).all()
               for x in jax.tree.leaves(jparams))
