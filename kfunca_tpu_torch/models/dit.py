"""DiT: a diffusion transformer for class-conditional image generation.

Counterpart of kfunca_tpu/models/dit.py (Peebles & Xie 2023), with its
parameter layout (models/weights.dit_params_from_jax carries a JAX pytree
across): adaLN-Zero conditioning (each block's modulation and the final
projection start at zero, so the model starts at an output of exactly 0),
DDPM epsilon-prediction training over a linear-beta schedule, and a DDIM
sampler with classifier-free guidance (cond and uncond as one 2B-batched
forward).  Patches are vision.patchify's block reshape and one matmul; the
attention is vision.encoder_attention's bidirectional fp32 einsum-softmax,
as the JAX package's.

The two frameworks draw other random numbers, so each random function is a
deterministic core and a draw from a torch.Generator: `dit_loss` draws t,
the noise and the label drops, then calls `dit_loss_core`; `ddim_sample`
draws its starting noise (and, for eta > 0, one noise a step), then runs
`ddim_loop`.  A caller holding another framework's draws hands them to the
cores.  The sampler is a Python loop over the steps (the JAX package's one
compiled lax.scan).

Params fp32; activations cfg.dtype; losses and schedule fp32.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..runtime.backend import resolve_device
from .mamba import _linear
from .transformer import _DTYPES, _plain_mm
from .vision import (ViTConfig, encoder_attention, merge_heads, patchify,
                     split_heads)


@dataclass(frozen=True)
class DiTConfig:
    """The JAX package's DiTConfig, field for field."""

    image_size: int = 32
    patch_size: int = 4
    channels: int = 3
    d_model: int = 256
    n_heads: int = 4
    n_layers: int = 4
    d_ff: int = 1024
    n_classes: int = 10
    timesteps: int = 1000
    dtype: str = "bfloat16"

    @property
    def n_patches(self) -> int:
        if self.image_size % self.patch_size:
            raise ValueError(f"image {self.image_size} is not a multiple of "
                             f"the patch {self.patch_size}")
        return (self.image_size // self.patch_size) ** 2

    @property
    def patch_dim(self) -> int:
        return self.patch_size ** 2 * self.channels

    @property
    def head_dim(self) -> int:
        if self.d_model % self.n_heads:
            raise ValueError(f"d_model {self.d_model} is not a multiple of "
                             f"n_heads {self.n_heads}")
        return self.d_model // self.n_heads

    @property
    def null_class(self) -> int:
        return self.n_classes  # the CFG "unconditional" row

    @property
    def act_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    def vit(self) -> ViTConfig:
        """The patchify-compatible shape view."""
        return ViTConfig(image_size=self.image_size,
                         patch_size=self.patch_size, channels=self.channels,
                         d_model=self.d_model, n_heads=self.n_heads,
                         n_layers=self.n_layers, d_ff=self.d_ff,
                         dtype=self.dtype)


def init_dit_params(seed: int, cfg: DiTConfig, device=None,
                    dtype=torch.float32):
    """Random params with the JAX init_dit_params laws (positions and class
    table N(0, 0.02^2), matrices U(-1/sqrt(fan_in), 1/sqrt(fan_in)), every
    modulation and the final projection zero), drawn from a
    torch.Generator seeded with `seed` on `device` (default: the CUDA
    device)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    d = cfg.d_model

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def normal(*shape):
        return (torch.randn(shape, generator=gen, device=dev) * 0.02).to(dtype)

    params = {
        "patch_proj": _linear(gen, cfg.patch_dim, d, dtype),
        "pos_embed": normal(cfg.n_patches, d),
        # the timestep MLP over the sinusoid; the class table has a null
        # row for CFG
        "t_mlp1": _linear(gen, 256, d, dtype), "t_mlp1_b": zeros(d),
        "t_mlp2": _linear(gen, d, d, dtype), "t_mlp2_b": zeros(d),
        "y_embed": normal(cfg.n_classes + 1, d),
        # adaLN-Zero final layer: modulation and projection zero
        "final_ada": zeros(d, 2 * d), "final_ada_b": zeros(2 * d),
        "final_proj": zeros(d, cfg.patch_dim),
        "final_proj_b": zeros(cfg.patch_dim),
        "blocks": [],
    }
    for _ in range(cfg.n_layers):
        params["blocks"].append({
            "wqkv": _linear(gen, d, 3 * d, dtype),
            "wo": _linear(gen, d, d, dtype),
            "w_fc": _linear(gen, d, cfg.d_ff, dtype),
            "w_proj": _linear(gen, cfg.d_ff, d, dtype),
            # adaLN-Zero: zero modulation => gates 0 => identity block
            "ada": zeros(d, 6 * d), "ada_b": zeros(6 * d),
        })
    return params


def timestep_embedding(t, dim: int = 256, max_period: float = 10000.0):
    """(B,) integer or float timesteps -> (B, dim) fp32 sinusoids."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    ang = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)


def _modulate(x, shift, scale):
    """LayerNorm without learnable affine (eps 1e-6), then the adaLN
    shift / scale conditioned on (t, y), in x's dtype."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = torch.square(xf - mu).mean(dim=-1, keepdim=True)
    h = (xf - mu) * torch.rsqrt(var + 1e-6)
    return (h * (1.0 + scale[:, None]) + shift[:, None]).to(x.dtype)


def _dit_block(x, c, p, cfg: DiTConfig):
    """x (B, N, d), c (B, d) fp32 conditioning -> (B, N, d)."""
    mods = F.silu(c) @ p["ada"].float() + p["ada_b"].float()  # fp32 (B, 6d)
    s1, sc1, g1, s2, sc2, g2 = mods.chunk(6, dim=-1)

    y = _modulate(x, s1, sc1)
    qkv = _plain_mm(y, p["wqkv"]).to(y.dtype)
    attn = merge_heads(encoder_attention(*split_heads(qkv, cfg.n_heads))
                       .to(x.dtype))
    x = x + (g1[:, None] * _plain_mm(attn, p["wo"])).to(x.dtype)

    y = _modulate(x, s2, sc2)
    act = F.gelu(_plain_mm(y, p["w_fc"]), approximate="tanh").to(y.dtype)
    return x + (g2[:, None] * _plain_mm(act, p["w_proj"])).to(x.dtype)


def unpatchify(x, cfg: DiTConfig):
    """(B, N, patch_dim) -> (B, H, W, C): the inverse of vision.patchify."""
    b = x.shape[0]
    p, c = cfg.patch_size, cfg.channels
    g = cfg.image_size // p
    x = x.reshape(b, g, g, p, p, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, cfg.image_size, cfg.image_size, c)


def dit_forward(params, images, t, y, cfg: DiTConfig):
    """Predict epsilon: images (B, H, W, C), t (B,) integer timesteps, y
    (B,) integer labels (null_class = unconditional) -> (B, H, W, C)
    fp32."""
    x = patchify(images, cfg.vit()).to(cfg.act_dtype)
    x = _plain_mm(x, params["patch_proj"]).to(cfg.act_dtype)
    x = x + params["pos_embed"].to(x.dtype)
    temb = timestep_embedding(t)
    temb = F.silu(temb @ params["t_mlp1"].float()
                  + params["t_mlp1_b"].float())
    temb = temb @ params["t_mlp2"].float() + params["t_mlp2_b"].float()
    c = temb + params["y_embed"][y.long()].float()  # (B, d) fp32
    for p in params["blocks"]:
        x = _dit_block(x, c, p, cfg)
    mods = F.silu(c) @ params["final_ada"].float() \
        + params["final_ada_b"].float()
    shift, scale = mods.chunk(2, dim=-1)
    x = _modulate(x, shift, scale)
    out = _plain_mm(x, params["final_proj"]) + params["final_proj_b"].float()
    return unpatchify(out, cfg)


# -- diffusion schedule and training -------------------------------------------


def alphas_bar(cfg: DiTConfig, device=None):
    """The DDPM linear-beta schedule's cumulative alpha, (T,) fp32 on
    `device` (default: the CUDA device).  The (1e-4, 0.02) endpoints are
    T = 1000's, scaled by 1000 / T for other T (the diffusers convention),
    which keeps the terminal SNR near zero."""
    scale = 1000.0 / cfg.timesteps
    betas = torch.linspace(scale * 1e-4, scale * 0.02, cfg.timesteps,
                           dtype=torch.float32, device=resolve_device(device))
    return torch.cumprod(1.0 - betas, dim=0)


def q_sample(x0, t, noise, ab):
    """The forward process: x_t = sqrt(ab_t) x0 + sqrt(1 - ab_t) eps."""
    a = ab[t.long()][:, None, None, None]
    return torch.sqrt(a) * x0.float() + torch.sqrt(1.0 - a) * noise


def dit_loss_core(params, images, t, noise, y, cfg: DiTConfig):
    """The epsilon-prediction MSE at given timesteps t (B,), noise (images'
    shape, fp32) and labels y (B,) with the dropped ones already the null
    class: dit_loss without its draws."""
    xt = q_sample(images, t, noise, alphas_bar(cfg, images.device))
    pred = dit_forward(params, xt.to(cfg.act_dtype), t, y, cfg)
    return torch.mean(torch.square(pred - noise))


def draw_loss_inputs(gen, images, labels, cfg: DiTConfig,
                     drop_prob: float = 0.1):
    """(t, noise, y) from the torch.Generator `gen`: t uniform over the
    timesteps, standard normal noise, each label dropped to the null class
    with drop_prob (which trains the CFG unconditional branch)."""
    b, dev = images.shape[0], images.device
    t = torch.randint(0, cfg.timesteps, (b,), generator=gen, device=dev)
    noise = torch.randn(images.shape, generator=gen, device=dev)
    drop = torch.rand((b,), generator=gen, device=dev) < drop_prob
    y = torch.where(drop, torch.full_like(labels.long(), cfg.null_class),
                    labels.long())
    return t, noise, y


def dit_loss(params, gen, images, labels, cfg: DiTConfig,
             drop_prob: float = 0.1):
    """Epsilon-prediction MSE at uniformly drawn t, labels dropped to the
    null class with drop_prob; the draws from the torch.Generator `gen`."""
    t, noise, y = draw_loss_inputs(gen, images, labels, cfg, drop_prob)
    return dit_loss_core(params, images, t, noise, y, cfg)


def make_dit_train_step(cfg: DiTConfig, oc=None, drop_prob: float = 0.1,
                        device=None):
    """step(params, opt_state, gen, images, labels) -> (params, opt_state,
    loss) on `device` (default: the CUDA device), the draws from the
    torch.Generator `gen`; the update is in place (models/train.py)."""
    from .train import (OptConfig, apply_update, check_params_device,
                        value_and_grad_aux)

    dev = resolve_device(device)
    oc = oc or OptConfig(lr=1e-3, weight_decay=0.0)

    def step(params, opt_state, gen, images, labels):
        check_params_device(params, dev)
        images = torch.as_tensor(images).to(dev)
        labels = torch.as_tensor(labels).to(dev)
        t, noise, y = draw_loss_inputs(gen, images, labels, cfg, drop_prob)
        loss, _, grads = value_and_grad_aux(
            lambda p: (dit_loss_core(p, images, t, noise, y, cfg), None),
            params)
        params, opt_state = apply_update(params, grads, opt_state, oc)
        return params, opt_state, loss

    return step


# -- DDIM sampling with classifier-free guidance --------------------------------


def ddim_timesteps(cfg: DiTConfig, steps: int) -> list:
    """The sampler's step subset, T - 1 down to 0 evenly spaced (float64
    linspace rounded half to even, as jnp's)."""
    return [int(t) for t in np.linspace(cfg.timesteps - 1, 0, steps).round()]


@torch.no_grad()
def ddim_step(params, x, labels, cfg: DiTConfig, t: int, ab_t, ab_prev,
              guidance: float = 1.0, eta: float = 0.0, noise=None):
    """One DDIM step at timestep t from x (B, H, W, C) fp32 to the next
    step's x: ab_t and ab_prev the schedule's alphas-bar at t and at the
    next step (1 after the last).  guidance > 1 runs cond / uncond as one
    2B-batched forward; eta > 0 adds `noise` at the scale sigma_t = eta *
    sqrt((1 - ab_prev) / (1 - ab_t)) * sqrt(1 - ab_t / ab_prev) (Song et
    al. 2021, eq. 16)."""
    b = labels.shape[0]
    labels = labels.long()
    tb = torch.full((b,), t, dtype=torch.long, device=x.device)
    if guidance == 1.0:
        eps = dit_forward(params, x.to(cfg.act_dtype), tb, labels, cfg)
    else:
        y2 = torch.cat([labels, torch.full_like(labels, cfg.null_class)])
        e = dit_forward(params, torch.cat([x, x]).to(cfg.act_dtype),
                        torch.cat([tb, tb]), y2, cfg)
        cond, uncond = e[:b], e[b:]
        eps = uncond + guidance * (cond - uncond)
    x0 = torch.clamp((x - torch.sqrt(1.0 - ab_t) * eps) / torch.sqrt(ab_t),
                     -1.5, 1.5)
    if eta == 0.0:
        return torch.sqrt(ab_prev) * x0 + torch.sqrt(1.0 - ab_prev) * eps
    sigma = (eta * torch.sqrt((1.0 - ab_prev) / (1.0 - ab_t))
             * torch.sqrt(1.0 - ab_t / ab_prev))
    return (torch.sqrt(ab_prev) * x0
            + torch.sqrt(torch.clamp(1.0 - ab_prev - sigma ** 2, min=0.0))
            * eps + sigma * noise)


def ddim_loop(params, x, labels, cfg: DiTConfig, steps: int = 50,
              guidance: float = 1.0, eta: float = 0.0, noises=None):
    """DDIM from the starting noise x (B, H, W, C) fp32: the deterministic
    core of ddim_sample, `steps` ddim_steps over ddim_timesteps (noises[i],
    one (B, H, W, C) tensor a step, where eta > 0).  Returns (B, H, W, C)
    fp32."""
    ts = ddim_timesteps(cfg, steps)
    ab = alphas_bar(cfg, x.device)
    one = torch.ones((), dtype=torch.float32, device=x.device)
    x = x.float()
    for i, t in enumerate(ts):
        # the step after the last denoises fully: ab_prev = 1
        ab_prev = ab[ts[i + 1]] if i + 1 < steps else one
        x = ddim_step(params, x, labels, cfg, t, ab[t], ab_prev, guidance,
                      eta, None if noises is None else noises[i])
    return x


def ddim_sample(params, gen, labels, cfg: DiTConfig, steps: int = 50,
                guidance: float = 1.0, eta: float = 0.0, device=None):
    """DDIM sampling on `device` (default: the CUDA device) from pure noise
    drawn from the torch.Generator `gen` there (eta > 0 draws one noise a
    step from it too): labels (B,) integers -> (B, H, W, C) fp32
    (ddim_loop)."""
    dev = resolve_device(device)
    if gen.device.type != dev.type:
        raise ValueError(f"the generator is on {gen.device}, the sampler "
                         f"runs on {dev}")
    labels = torch.as_tensor(labels).to(dev)
    shape = (labels.shape[0], cfg.image_size, cfg.image_size, cfg.channels)
    x = torch.randn(shape, generator=gen, device=dev)
    noises = ([torch.randn(shape, generator=gen, device=dev)
               for _ in range(steps)] if eta != 0.0 else None)
    return ddim_loop(params, x, labels, cfg, steps, guidance, eta, noises)
