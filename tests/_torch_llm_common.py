"""Shared by the LLM trainer's tests against the JAX package
(``test_torch_train_llm.py``, ``test_torch_train_llm_decoders.py``,
``test_torch_train_llm_recurrent.py``): reduced configs of both packages,
JAX params loaded into the port, the trainer's batches, and the JAX param
tree as the port's parameter names.

Tolerances (f32 on both sides; matmuls, softmax and the recurrences sum in
other orders): the loss within LOSS_RTOL relative, each gradient within
GRAD_TOL of its JAX leaf's largest element. After ``train_llm``'s steps the
parameters are held to TRAJ_ATOL, except elements whose gradient fell below
NEAR_ZERO at some step: Adam's update ``g / (|g| + eps)`` turns the rounding
of a gradient that small into an update error of up to the learning rate, so
there the bound is 2 lr a step (``tests/test_torch_train_trajectory.py``
makes the same split for the GNN).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.launch import train as jtrain
from repro.models import registry as jregistry
from repro_torch.configs import get_config
from repro_torch.data.tokens import token_batches
from repro_torch.launch import train as ptrain
from repro_torch.models import convert

B, S = 4, 64
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-5
TRAJ_ATOL = 1e-6
NEAR_ZERO = 1e-6
# at most this share of a model's elements may fall under NEAR_ZERO (the
# exact zeros of unused embedding rows not counted): 0.15-0.5 % seen, 2.2 %
# for whisper, whose zero frames leave its encoder's gradients small
MAX_NEAR_ZERO = 0.03
LR = 3e-4
# leaves whose exact gradient is zero: the sLSTM's output h = o C / N is
# unchanged when every input gate's pre-activation shifts by one constant
# (C and N scale alike), so its input-gate bias gets only rounding residues
# (3.5e-10 in JAX, 4.9e-10 apart from the port's, at a tree whose largest
# gradient element is O(0.1)); held on both sides to GRAD_TOL of the tree's
# largest gradient element instead (the invariance itself is tested in
# test_torch_train_llm_recurrent.py)
ZERO_GRAD = ("slstm.w_i.b",)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The reduced models run many small ops, which a pool of intra-op
    threads only slows when test processes share the cores (imported, and
    so used, by each of the three test files)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def configs(arch: str):
    return jax_get_config(arch).reduced(), get_config(arch).reduced()


def port_model(tree, cfg):
    """The port's model of ``cfg``'s family holding a JAX param tree, on the
    CPU."""
    tree = jax.tree_util.tree_map(np.asarray, tree)
    if cfg.is_encoder_decoder:
        return convert.whisper_from_jax(tree, cfg, device="cpu")
    if cfg.ssm is not None and cfg.attn_every:
        return convert.hybrid_from_jax(tree, cfg, device="cpu")
    if cfg.ssm is not None:
        return convert.xlstm_from_jax(tree, cfg, device="cpu")
    return convert.transformer_from_jax(tree, cfg, device="cpu")


def train_batch(cfg, seed: int = 0) -> dict:
    """The first batch ``train_llm`` draws with ``seed`` (numpy), with its
    zero patch or frame embeddings."""
    b = next(token_batches(cfg.vocab_size, B, S, 1, seed))
    if cfg.frontend == "vision":
        b["prefix_embeds"] = np.zeros((B, cfg.n_frontend_tokens,
                                       cfg.d_model), np.float32)
    if cfg.frontend == "audio":
        b["audio_embeds"] = np.zeros((B, cfg.n_frontend_tokens,
                                      cfg.d_model), np.float32)
    return b


def stacked_names(cfg) -> tuple:
    return ("enc_blocks", "dec_blocks") if cfg.is_encoder_decoder \
        else ("blocks",)


def named_leaves(tree, cfg):
    """JAX's ``tree_leaves(tree)`` as ``(port name, array, leaf max)``: a
    leaf of a stacked subtree split into its groups (``blocks.{g}...``),
    each with the largest |element| of the whole JAX leaf."""
    out = []
    stacked = stacked_names(cfg)
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = [str(p.key) if hasattr(p, "key") else str(p.idx)
                for p in path]
        leaf = np.asarray(leaf)
        top = float(np.abs(leaf).max())
        if keys[0] in stacked:
            out.extend((".".join([keys[0], str(g), *keys[1:]]), leaf[g], top)
                       for g in range(leaf.shape[0]))
        else:
            out.append((".".join(keys), leaf, top))
    return out


def jax_loss_and_grads(arch: str, key: int = 0):
    """JAX's reduced params (``PRNGKey(key)``), the batch, and
    ``jax.value_and_grad(api.train_loss)`` of it, jitted."""
    jcfg, cfg = configs(arch)
    api = jregistry.get_model(jcfg)
    params = api.init(jax.random.PRNGKey(key))
    batch = train_batch(cfg)
    loss, grads = jax.jit(jax.value_and_grad(api.train_loss))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    return dict(cfg=cfg, params=params, batch=batch, loss=float(loss),
                grads=named_leaves(grads, cfg))


def port_loss_and_grads(model, cfg, batch):
    """The registry's ``train_loss`` and its backward on the CPU; returns
    the loss and ``{name: grad}``."""
    from repro_torch.models import registry
    model.zero_grad(set_to_none=True)
    loss = registry.get_model(cfg).train_loss(
        model, {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    return float(loss.detach()), {n: p.grad.detach().numpy() for n, p in
                         convert.llm_leaves(model)}


def assert_matches_jax(ref: dict, model=None):
    """The port's loss and gradients against JAX's (``ref`` from
    :func:`jax_loss_and_grads`), and ``llm_leaves``' order against
    ``tree_leaves``'."""
    cfg = ref["cfg"]
    model = model if model is not None else port_model(ref["params"], cfg)
    loss, grads = port_loss_and_grads(model, cfg, ref["batch"])
    assert [n for n, _ in convert.llm_leaves(model)] == \
        [n for n, *_ in ref["grads"]]
    np.testing.assert_allclose(loss, ref["loss"], rtol=LOSS_RTOL)
    tree_top = max(top for *_, top in ref["grads"])
    for name, want, top in ref["grads"]:
        if name.endswith(ZERO_GRAD):
            for g in (grads[name], want):
                assert float(np.abs(g).max()) <= GRAD_TOL * tree_top, name
            continue
        err = float(np.abs(grads[name] - want).max())
        assert err <= GRAD_TOL * top, (name, err, top)


def assert_trajectory_matches_jax(arch: str, steps: int = 3):
    """JAX's ``train_llm(arch, True, steps)`` against the port's from JAX's
    init (``PRNGKey(0)``), on the CPU: the per-step losses and the
    parameters after the last step (the port's gradients of each step read
    by a hook on every parameter)."""
    jcfg, cfg = configs(arch)
    jparams, jlosses = jtrain.train_llm(arch, True, steps, log_every=steps)
    init = jregistry.get_model(jcfg).init(jax.random.PRNGKey(0))
    model = port_model(init, cfg)
    near = {}

    def record(p, name):
        small = (p.grad.abs() < NEAR_ZERO) & (p.grad != 0)
        near[name] = small if name not in near else near[name] | small
    hooks = [p.register_post_accumulate_grad_hook(
        lambda p, name=name: record(p, name))
        for name, p in convert.llm_leaves(model)]
    try:
        model, losses = ptrain.train_llm(arch, True, steps, device="cpu",
                                         model=model, log_every=steps)
    finally:
        for h in hooks:
            h.remove()
    np.testing.assert_allclose(losses, jlosses, rtol=LOSS_RTOL)
    got = dict(convert.llm_leaves(model))
    bound = 2 * LR * steps
    n_near = n_all = 0
    for name, want, _ in named_leaves(jparams, cfg):
        diff = np.abs(got[name].detach().numpy() - want)
        nz = near[name].numpy()
        n_near += int(nz.sum())
        n_all += nz.size
        assert diff[~nz].max(initial=0.0) <= TRAJ_ATOL, \
            (name, float(diff[~nz].max()))
        assert diff[nz].max(initial=0.0) <= bound, name
    assert n_near <= MAX_NEAR_ZERO * n_all, (n_near, n_all)
