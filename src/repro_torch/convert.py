"""Carry state between the JAX reference and the port, through numpy.

* ``to_torch``: a numpy array (a JAX output after ``np.asarray``) into a
  tensor on a device; ``uint32`` (bitplanes) travels exactly, as an int32
  view of the same bits, and comes out as a ``torch.uint32`` view;
* ``to_numpy``: a tensor back to numpy, ``uint32`` included;
* ``codec_config``: a port ``BlockCodecConfig`` from any object with the
  reference config's fields (``bits``, ``block``, ``delta``);
* ``params_from_jax``: the port's model parameters from the reference's
  ``DenseParams`` or ``EncDecParams`` tree with numpy leaves;
* ``state_from_jax``: the port's ``TrainState`` from the reference's
  (params, AdamW moments and count, error-feedback residuals, step) with
  numpy leaves, whole or (``mesh``) as one rank's blocks.

``bfloat16`` numpy arrays (as JAX hands them over) travel exactly, as the
same 16-bit words.  Nothing here imports JAX: the caller hands over numpy
arrays.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.blockcodec import BlockCodecConfig


def to_torch(a, device: str | torch.device = "cuda") -> torch.Tensor:
    a = np.array(a, order="C")  # a writable copy: JAX buffers are read-only
    if a.dtype == np.uint32:
        return torch.from_numpy(a.view(np.int32)).to(device).view(torch.uint32)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).to(device).view(torch.bfloat16)
    return torch.from_numpy(a).to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.uint32:
        return t.view(torch.int32).numpy().view(np.uint32)
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)  # exact; numpy has no bfloat16 of its own
    return t.numpy()


def codec_config(cfg) -> BlockCodecConfig:
    return BlockCodecConfig(bits=int(cfg.bits), block=int(cfg.block),
                            delta=bool(cfg.delta))


def params_from_jax(tree, cfg, device: str | torch.device = "cuda"):
    """The port's ``DenseParams`` (or ``EncDecParams``) from the reference's,
    leaf for leaf.

    ``tree`` is the reference's ``transformer.DenseParams`` or
    ``encdec.EncDecParams`` after ``np.asarray`` on every leaf
    (``jax.tree.map(np.asarray, params)``); it is read by field name.  Its
    stacked ``[n_layers, ...]`` leaves (``enc_layers`` and ``dec_layers``
    for the encoder-decoder family) are split per layer; a field the family
    has not (``None``) stays ``None``.  Weights keep the ``(in, out)``
    orientation, so ``x @ wq`` is the same product.  Every family.
    """
    from repro_torch.models import encdec
    from repro_torch.models import layers as L
    from repro_torch.models import moe as M
    from repro_torch.models import ssm as S
    from repro_torch.models import transformer

    transformer.check_family(cfg, decoder_only=False)

    def t(a):
        return None if a is None else to_torch(a, device)

    def at(a, i):
        return None if a is None else t(np.asarray(a)[i])

    def module(cls, node, i):
        return None if node is None else cls(
            **{f: at(getattr(node, f), i) for f in node._fields})

    e = tree.embed
    embed = L.EmbedParams(table=t(e.table), unembed=t(e.unembed),
                          final_norm=t(e.final_norm))
    if cfg.family == "encdec":
        attn = {"attn", "self_attn", "cross_attn"}

        def layer(cls, node, i):
            return cls(**{f: module(L.AttnParams, getattr(node, f), i) if f in attn
                          else module(L.MlpParams, node.mlp, i) if f == "mlp"
                          else at(getattr(node, f), i) for f in cls.FIELDS})
        return encdec.EncDecParams(
            embed, [layer(encdec.EncLayer, tree.enc_layers, i)
                    for i in range(cfg.enc_layers)],
            t(tree.enc_norm),
            [layer(encdec.DecLayer, tree.dec_layers, i)
             for i in range(cfg.n_layers)])
    ly = tree.layers
    layers = [transformer.LayerParams(
        ln1=at(ly.ln1, i), attn=module(L.AttnParams, ly.attn, i),
        ssm=module(S.SsmParams, ly.ssm, i), ln_attn_out=at(ly.ln_attn_out, i),
        ln_ssm_out=at(ly.ln_ssm_out, i), ln2=at(ly.ln2, i),
        mlp=module(L.MlpParams, ly.mlp, i), moe=module(M.MoeParams, ly.moe, i))
        for i in range(cfg.n_layers)]
    return transformer.DenseParams(embed, layers)


def state_from_jax(tree, cfg, device: str | torch.device = "cuda",
                   pod: int | None = None, mesh=None, rc=None):
    """The port's ``train.step.TrainState`` from the reference's, leaf for leaf.

    ``tree`` is the reference's ``TrainState`` after ``np.asarray`` on every
    leaf.  The moments keep their dtype and are keyed by the port's
    parameter names; ``count`` and ``step`` stay int32 scalars.  The
    error-feedback residuals (``(n_pods, ...)`` leaves, ``(n_pods,
    n_layers, ...)`` where stacked) become f32 ``(n_pods, *shape)`` tensors
    keyed by parameter name; with ``pod``, only that pod's, ``(1,
    *shape)``, as a rank of that pod holds them.  With ``mesh`` (and the
    run config ``rc`` whose rules place the leaves) every leaf is this
    rank's block of it, as ``train.step.init_state(..., mesh)`` holds them,
    and the residuals are this rank's pod's.
    """
    from repro_torch.optim.adamw import AdamState
    from repro_torch.train.step import STACKED, TrainState

    def named(t):
        return {n: p.detach() for n, p in
                params_from_jax(t, cfg, device).named_parameters()}

    def pods_first(node, stacked=False):
        """The residual tree with each stacked leaf's layer axis first, so
        ``params_from_jax`` splits it per layer."""
        if node is None or not hasattr(node, "_fields"):
            return None if node is None else (
                np.swapaxes(node, 0, 1) if stacked else node)
        return type(node)(*(pods_first(getattr(node, f), stacked or f in STACKED)
                            for f in node._fields))

    if mesh is not None and "pod" in mesh.axis_names:
        pod = mesh.coords["pod"] if tree.resid is not None else pod
    resid = None
    if tree.resid is not None:
        resid = named(pods_first(tree.resid))
        if pod is not None:
            resid = {n: r[pod:pod + 1].clone() for n, r in resid.items()}
    opt = AdamState(mu=named(tree.opt.mu), nu=named(tree.opt.nu),
                    count=to_torch(tree.opt.count, device))
    state = TrainState(params=params_from_jax(tree.params, cfg, device), opt=opt,
                       resid=resid, step=to_torch(tree.step, device))
    return state if mesh is None else _blocks(state, cfg, rc, mesh)


def _blocks(state, cfg, rc, mesh):
    """``state`` cut to this rank's blocks on ``mesh``."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import model_zoo
    from repro_torch.train import step as train_step

    api = model_zoo.get_api(cfg, rc, "cpu")
    specs = train_step.param_partition(api, rc, mesh)
    for n, p in state.params.named_parameters():
        shd.shard_parameter(p, specs[n], mesh)
    cut = {n: shd.P(*s) for n, s in specs.items()}
    mu = {n: shd.local_slice(t, cut[n], mesh).clone() for n, t in state.opt.mu.items()}
    nu = {n: shd.local_slice(t, cut[n], mesh).clone() for n, t in state.opt.nu.items()}
    resid = None if state.resid is None else {
        n: shd.local_slice(r, shd.P(None, *cut[n]), mesh).clone()
        for n, r in state.resid.items()}
    return state._replace(opt=state.opt._replace(mu=mu, nu=nu), resid=resid)
