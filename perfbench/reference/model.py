"""A plain PyTorch Intro-TC-VAE: the yardstick that decides ``correct``.

Written from the published description (Soft-IntroVAE, Daniel and Tamar,
arXiv 2012.13253; the beta-TC-VAE total correlation, Chen et al., arXiv
1802.04942) as the upstream repository (github.com/meffmadd/intro-tc-vae)
executes it, in float32 with no kernels, no graphs, no paired passes and
no caches. It imports nothing of the program under test: its parameters
are a dict of tensors named as the program's ``state_dict`` names them,
so that one set of weights made by the benchmark can be handed to both.

* ``encoder`` / ``decoder``: a 5x5 stem conv, BatchNorm (eps 1e-4, the
  batch's biased variance max(0, E[x^2] - E[x]^2)), LeakyReLU 0.2, AvgPool
  2; per stage a block of the configuration's arch (``Arch.block``); a
  Linear head to (mu, logvar); the decoder mirrors it with nearest x2
  upsampling, a 5x5 predict conv with bias and a sigmoid. NCHW, features
  flattened channel-major. The blocks (upstream ``models.py``):

  - ``conv``: conv3x3 - BN - LReLU - conv3x3 - BN - LReLU, BN eps 1e-4;
  - ``res``: identity = x, or a 1x1 ``conv_expand`` without bias where the
    channels change; LReLU(BN(conv3x3(LReLU(BN(conv3x3(x))))) + identity),
    BN eps 1e-5 (torch's default: upstream passes none);
  - ``inception``: branch_0 a 1x1 conv - BN - LReLU to out/2, branch_1 two
    of those (in -> out, out -> out/2), concatenated, a 1x1 ``conv`` with
    bias, + identity (or a 1x1 ``conv_expand``), LReLU; BN eps 1e-4.
* ``intro_tc_step``: the two-phase step, the encoder phase then the
  decoder phase on the encoder phase's update, each pass once and in
  sequence, every KL site (beta - 1) TC + KL with the stratified
  minibatch TC estimate (variance floor 1e-4, log density clamped at
  -50, the column-structured importance weights), and Adam (0.9, 0.999,
  1e-8) on each network.
* ``quantizer``: where the step rounds. ``None`` is float32 throughout;
  ``fp8`` rounds every conv and dense input, weight and output and every
  BatchNorm output to float8 e4m3, and the gradient at each of those
  points on the way back to e5m2 (float8 training's hybrid recipe;
  per-tensor power-of-two scales): the control, one precision below the
  bfloat16 the configurations state.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

LEAKY = 0.2
VAR_FLOOR = 1e-4
LOG_PROB_FLOOR = -50.0
LOG_2PI = math.log(2.0 * math.pi)
ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8
NOISE_KEYS = ("prior", "real", "rec_e", "fake_e", "rec_d", "fake_d")


@dataclasses.dataclass(frozen=True)
class Arch:
    """The shape of one configuration's model."""

    image_size: int
    channels: tuple
    cdim: int
    zdim: int
    block: str = "conv"

    def __post_init__(self):
        if self.block not in BLOCKS:
            raise ValueError(f"the reference has no {self.block!r} blocks "
                             f"(it has {sorted(BLOCKS)})")

    @property
    def bottom(self) -> int:
        """Side of the encoder's last feature map."""
        return self.image_size // (2 ** len(self.channels))


@dataclasses.dataclass(frozen=True)
class Hyper:
    """The loss weights of the intro step and Adam's learning rate."""

    beta_kl: float
    beta_rec: float
    beta_neg: float
    gamma_r: float
    lr: float
    dataset_size: int


# ---------------------------------------------------------------------------
# leaves
# ---------------------------------------------------------------------------

def _stages(arch: Arch):
    """(encoder stages, decoder stages): (name, in, out) of each block."""
    enc, cc, sz = [], arch.channels[0], arch.image_size // 2
    for ch in arch.channels[1:]:
        enc.append((f"res_in_{sz}", cc, ch))
        cc, sz = ch, sz // 2
    enc.append((f"res_in_{sz}", cc, cc))
    dec, cc, sz = [], arch.channels[-1], arch.bottom
    for ch in arch.channels[::-1]:
        dec.append((f"res_in_{sz}", cc, ch))
        cc, sz = ch, sz * 2
    dec.append((f"res_in_{sz}", cc, cc))
    return enc, dec


def _conv_leaves(prefix: str, cin: int, cout: int, k: int, bias: bool = False) -> list:
    out = [(f"{prefix}.weight", (cout, cin, k, k), "w", cin * k * k)]
    if bias:
        out.append((f"{prefix}.bias", (cout,), "b", cin * k * k))
    return out


def _bn_leaves(prefix: str, c: int) -> list:
    return [(f"{prefix}.weight", (c,), "bn_w", 0), (f"{prefix}.bias", (c,), "bn_b", 0)]


def _expand_leaves(prefix: str, cin: int, cout: int) -> list:
    return _conv_leaves(f"{prefix}.conv_expand", cin, cout, 1) if cin != cout else []


def _conv_block_leaves(prefix: str, cin: int, cout: int) -> list:
    return (_conv_leaves(f"{prefix}.conv1", cin, cout, 3) + _bn_leaves(f"{prefix}.bn1", cout)
            + _conv_leaves(f"{prefix}.conv2", cout, cout, 3) + _bn_leaves(f"{prefix}.bn2", cout))


def _res_block_leaves(prefix: str, cin: int, cout: int) -> list:
    return _expand_leaves(prefix, cin, cout) + _conv_block_leaves(prefix, cin, cout)


def _inception_block_leaves(prefix: str, cin: int, cout: int) -> list:
    """branch_1's middle width is out (the port's scale 1.0)."""
    out = _expand_leaves(prefix, cin, cout)
    for unit, a, b in (("branch_0", cin, cout // 2), ("branch_1.0", cin, cout),
                       ("branch_1.1", cout, cout // 2)):
        out += _conv_leaves(f"{prefix}.{unit}.conv", a, b, 1)
        out += _bn_leaves(f"{prefix}.{unit}.batch_norm", b)
    return out + _conv_leaves(f"{prefix}.conv", cout, cout, 1, bias=True)


def leaf_specs(arch: Arch) -> list:
    """Every parameter, in the order of the program's ``named_parameters``:
    (name, shape, kind, fan_in). ``kind`` is "w" (a conv or dense weight),
    "b" (a conv or dense bias), "bn_w" or "bn_b"."""
    block = BLOCKS[arch.block][0]
    enc, dec = _stages(arch)
    feat = arch.bottom ** 2 * arch.channels[-1]
    out = _conv_leaves("encoder.main.0", arch.cdim, arch.channels[0], 5)
    out += _bn_leaves("encoder.main.1", arch.channels[0])
    for name, cin, cout in enc:
        out += block(f"encoder.main.{name}", cin, cout)
    out.append(("encoder.fc.weight", (2 * arch.zdim, feat), "w", feat))
    out.append(("encoder.fc.bias", (2 * arch.zdim,), "b", feat))
    out.append(("decoder.fc.0.weight", (feat, arch.zdim), "w", arch.zdim))
    out.append(("decoder.fc.0.bias", (feat,), "b", arch.zdim))
    for name, cin, cout in dec:
        out += block(f"decoder.main.{name}", cin, cout)
    out += _conv_leaves("decoder.main.predict", arch.channels[0], arch.cdim, 5, bias=True)
    return out


def make_weights(arch: Arch, seed: int, device) -> dict:
    """The weights of a seed, made on ``device`` in one draw: conv and
    dense weights and biases U(+-1/sqrt(fan_in)) (PyTorch's default, and
    the upstream model's), BatchNorm scales U(0.8, 1.2) and shifts
    U(-0.1, 0.1). Float32, name -> tensor."""
    specs = leaf_specs(arch)
    sizes = [int(np.prod(shape)) for _, shape, _, _ in specs]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.rand(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    flat = flat.mul_(2.0).sub_(1.0)  # U(-1, 1)
    out = {}
    for (name, shape, kind, fan_in), part in zip(specs, flat.split(sizes)):
        t = part.view(shape)
        if kind in ("w", "b"):
            t = t * (1.0 / math.sqrt(fan_in))
        elif kind == "bn_w":
            t = 1.0 + 0.2 * t
        else:
            t = 0.1 * t
        out[name] = t
    return out


# ---------------------------------------------------------------------------
# rounding
# ---------------------------------------------------------------------------

FP8_FORMATS = {"e4m3": (torch.float8_e4m3fn, 448.0), "e5m2": (torch.float8_e5m2, 57344.0)}


def _round_fp8(x: torch.Tensor, fmt: str) -> torch.Tensor:
    """x rounded to float8 ``fmt`` under a per-tensor power-of-two scale
    that puts its largest magnitude near the format's top."""
    dtype, top = FP8_FORMATS[fmt]
    amax = x.abs().amax().clamp_min(1e-30)
    scale = torch.exp2(torch.floor(torch.log2(top / amax)))
    return (x * scale).to(dtype).to(x.dtype) / scale


class _Fp8(torch.autograd.Function):
    """float8 training's hybrid recipe: the value rounded to e4m3 going
    forward, its gradient to e5m2 going back."""

    @staticmethod
    def forward(ctx, x):
        return _round_fp8(x, "e4m3")

    @staticmethod
    def backward(ctx, g):
        return _round_fp8(g, "e5m2")


def _fp8(x: torch.Tensor) -> torch.Tensor:
    return _Fp8.apply(x)


QUANTIZERS: dict = {None: lambda x: x, "fp8": _fp8}


# ---------------------------------------------------------------------------
# the networks
# ---------------------------------------------------------------------------

def _conv(p, name, x, q, pad):
    bias = p.get(f"{name}.bias")
    y = F.conv2d(q(x), q(p[f"{name}.weight"]), None if bias is None else q(bias), padding=pad)
    return q(y)


def _bn(p, name, x, q, stats: Optional[dict], record: Optional[dict], eps: float):
    """Train mode (``stats`` None): the batch's statistics; eval mode:
    ``stats``' running ones. ``record`` collects each layer's batch
    (mean, var)."""
    c = x.shape[1]
    w = p[f"{name}.weight"].view(1, c, 1, 1)
    b = p[f"{name}.bias"].view(1, c, 1, 1)
    if stats is not None:
        mean = stats[f"{name}.running_mean"].view(1, c, 1, 1)
        var = stats[f"{name}.running_var"].view(1, c, 1, 1)
    else:
        mean = x.mean(dim=(0, 2, 3), keepdim=True)
        var = torch.clamp((x * x).mean(dim=(0, 2, 3), keepdim=True) - mean * mean, min=0.0)
        if record is not None:
            record[name] = (mean.detach().flatten(), var.detach().flatten())
    return q((x - mean) * torch.rsqrt(var + eps) * w + b)


def _conv_bn_act(p, conv, bn, x, q, stats, record, eps: float, pad: int):
    return F.leaky_relu(_bn(p, bn, _conv(p, conv, x, q, pad), q, stats, record, eps), LEAKY)


def _identity(p, name, x, q):
    expand = f"{name}.conv_expand"
    return _conv(p, expand, x, q, 0) if f"{expand}.weight" in p else x


def _conv_block(p, name, x, q, stats, record):
    x = _conv_bn_act(p, f"{name}.conv1", f"{name}.bn1", x, q, stats, record, 1e-4, 1)
    return _conv_bn_act(p, f"{name}.conv2", f"{name}.bn2", x, q, stats, record, 1e-4, 1)


def _res_block(p, name, x, q, stats, record):
    identity = _identity(p, name, x, q)
    y = _conv_bn_act(p, f"{name}.conv1", f"{name}.bn1", x, q, stats, record, 1e-5, 1)
    y = _bn(p, f"{name}.bn2", _conv(p, f"{name}.conv2", y, q, 1), q, stats, record, 1e-5)
    return F.leaky_relu(y + identity, LEAKY)


def _inception_block(p, name, x, q, stats, record):
    identity = _identity(p, name, x, q)

    def unit(sub, y):
        return _conv_bn_act(p, f"{name}.{sub}.conv", f"{name}.{sub}.batch_norm", y, q, stats,
                            record, 1e-4, 0)

    y = torch.cat([unit("branch_0", x), unit("branch_1.1", unit("branch_1.0", x))], dim=1)
    return F.leaky_relu(_conv(p, f"{name}.conv", y, q, 0) + identity, LEAKY)


# arch -> (its block's leaves, its block's forward)
BLOCKS = {"conv": (_conv_block_leaves, _conv_block),
          "res": (_res_block_leaves, _res_block),
          "inception": (_inception_block_leaves, _inception_block)}


def encoder(p: dict, arch: Arch, x: torch.Tensor, q: Callable = QUANTIZERS[None],
            stats: Optional[dict] = None, record: Optional[dict] = None):
    """x [B, C, H, W] in [0, 1] -> (mu, logvar), [B, z] each."""
    enc, _ = _stages(arch)
    block = BLOCKS[arch.block][1]
    y = _conv_bn_act(p, "encoder.main.0", "encoder.main.1", x, q, stats, record, 1e-4, 2)
    y = F.avg_pool2d(y, 2)
    for i, (name, _, _) in enumerate(enc):
        y = block(p, f"encoder.main.{name}", y, q, stats, record)
        if i < len(enc) - 1:
            y = F.avg_pool2d(y, 2)
    y = q(F.linear(q(y.flatten(1)), q(p["encoder.fc.weight"]), q(p["encoder.fc.bias"])))
    mu, logvar = y.chunk(2, dim=1)
    return mu, logvar


def decoder(p: dict, arch: Arch, z: torch.Tensor, q: Callable = QUANTIZERS[None],
            stats: Optional[dict] = None, record: Optional[dict] = None) -> torch.Tensor:
    """z [B, z] -> image [B, C, H, W] in [0, 1]."""
    _, dec = _stages(arch)
    block = BLOCKS[arch.block][1]
    s = arch.bottom
    y = q(F.linear(q(z), q(p["decoder.fc.0.weight"]), q(p["decoder.fc.0.bias"])))
    y = F.leaky_relu(y, LEAKY).view(z.shape[0], arch.channels[-1], s, s)
    for i, (name, _, _) in enumerate(dec):
        y = block(p, f"decoder.main.{name}", y, q, stats, record)
        if i < len(dec) - 1:
            y = F.interpolate(y, scale_factor=2, mode="nearest")
    return torch.sigmoid(_conv(p, "decoder.main.predict", y, q, 2))


def unit_to_u8(img: torch.Tensor) -> torch.Tensor:
    """[0, 1] -> uint8 as an image export truncates: floor(clip(x) * 255)."""
    return torch.floor(torch.clamp(img, 0.0, 1.0) * 255.0).to(torch.uint8)


def calibrated_stats(p: dict, arch: Arch, z: torch.Tensor) -> dict:
    """Running statistics for the decoder's eval mode: each BatchNorm's
    batch statistics over a train-mode pass of ``z``, so that a model made
    from a seed decodes images that use the whole range, as a trained
    one does."""
    record: dict = {}
    with torch.no_grad():
        decoder(p, arch, z, record=record)
    out = {}
    for name, (mean, var) in record.items():
        out[f"{name}.running_mean"] = mean.clone()
        out[f"{name}.running_var"] = var.clone()
    return out


# ---------------------------------------------------------------------------
# the loss terms
# ---------------------------------------------------------------------------

def log_importance_weights(batch: int, dataset_size: int, device) -> torch.Tensor:
    """The stratified estimate's [B, B] log weights as the upstream code
    builds them: with M = B - 1 its flat stride M + 1 = B walks a column,
    so column 0 holds 1/N (strat_weight at row M - 1), column 1
    strat_weight, the rest 1/M."""
    n, m = float(dataset_size), batch - 1
    strat = (n - m) / (n * m)
    w = np.full((batch, batch), 1.0 / m, dtype=np.float64)
    flat = w.reshape(-1)
    flat[:: m + 1] = 1.0 / n
    flat[1 :: m + 1] = strat
    w[m - 1, 0] = strat
    return torch.tensor(np.log(w).astype(np.float32), device=device)


def total_correlation(z, mu, logvar, dataset_size: int) -> torch.Tensor:
    """Per-sample stratified TC: log q(z_j) - sum_l log q(z_jl), from the
    [j, i, l] log densities log N(z_jl | mu_il, var_jl) (the sample's
    variance, as executed upstream), variance floored at 1e-4."""
    var = torch.clamp(torch.exp(logvar), min=VAR_FLOOR)[:, None, :]
    lp = -0.5 * (torch.log(var) + (z[:, None, :] - mu[None, :, :]) ** 2 / var + LOG_2PI)
    lp = torch.clamp(lp, min=LOG_PROB_FLOOR)
    iw = log_importance_weights(z.shape[0], dataset_size, z.device)
    prod_marginals = torch.logsumexp(iw[:, :, None] + lp, dim=1).sum(dim=1)
    joint = torch.logsumexp(iw + lp.sum(dim=2), dim=1)
    return joint - prod_marginals


def kl_site(z, mu, logvar, beta: float, dataset_size: int) -> torch.Tensor:
    """(beta - 1) TC + KL(q || N(0, I)), per sample."""
    kl = -0.5 * torch.sum(1.0 + logvar - torch.exp(logvar) - mu * mu, dim=1)
    return (beta - 1.0) * total_correlation(z, mu, logvar, dataset_size) + kl


def sq_err(target, out) -> torch.Tensor:
    """Per-sample summed squared error, the target detached."""
    return ((out - target.detach()) ** 2).flatten(1).sum(dim=1)


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Adam:
    """Adam on a dict of leaves: moments and a step count of its own."""

    lr: float
    m: dict = dataclasses.field(default_factory=dict)
    v: dict = dataclasses.field(default_factory=dict)
    t: int = 0

    def update(self, params: dict, grads: dict) -> None:
        b1, b2 = ADAM_BETAS
        self.t += 1
        c1, c2 = 1.0 - b1 ** self.t, 1.0 - b2 ** self.t
        for k, g in grads.items():
            m = self.m[k] = b1 * self.m.get(k, torch.zeros_like(g)) + (1.0 - b1) * g
            v = self.v[k] = b2 * self.v.get(k, torch.zeros_like(g)) + (1.0 - b2) * g * g
            params[k] = params[k] - (self.lr / c1) * m / (torch.sqrt(v) / math.sqrt(c2)
                                                         + ADAM_EPS)


def split(params: dict) -> tuple:
    """(encoder leaves, decoder leaves)."""
    return ({k: v for k, v in params.items() if k.startswith("encoder.")},
            {k: v for k, v in params.items() if k.startswith("decoder.")})


def intro_tc_step(params: dict, opt_e: Adam, opt_d: Adam, arch: Arch, h: Hyper,
                  x: torch.Tensor, noise: dict, q: Callable = QUANTIZERS[None]) -> dict:
    """One step in place on ``params`` (name -> float32 tensor); returns
    ``loss_enc``, ``loss_dec`` (floats) and ``grads_e`` / ``grads_d``,
    the gradients each network's Adam was handed."""
    scale = 1.0 / (arch.cdim * arch.image_size ** 2)
    n = h.dataset_size

    # ---- the encoder phase: only the encoder's leaves are differentiated
    pe = {k: v.detach().requires_grad_(True) for k, v in split(params)[0].items()}
    pd = {k: v.detach() for k, v in split(params)[1].items()}
    fake = decoder(pd, arch, noise["prior"], q)
    mu, logvar = encoder(pe, arch, x, q)
    z = mu + noise["real"] * torch.exp(0.5 * logvar)
    rec = decoder(pd, arch, z, q)
    loss_rec = h.beta_rec * sq_err(x, rec).mean()
    kl_real = kl_site(z, mu, logvar, h.beta_kl, n).mean()
    rec_mu, rec_logvar = encoder(pe, arch, rec.detach(), q)
    z_rec = rec_mu + noise["rec_e"] * torch.exp(0.5 * rec_logvar)
    rec_rec = decoder(pd, arch, z_rec, q)
    fake_mu, fake_logvar = encoder(pe, arch, fake.detach(), q)
    z_fake = fake_mu + noise["fake_e"] * torch.exp(0.5 * fake_logvar)
    rec_fake = decoder(pd, arch, z_fake, q)
    kl_rec = kl_site(z_rec, rec_mu, rec_logvar, h.beta_neg, n)
    kl_fake = kl_site(z_fake, fake_mu, fake_logvar, h.beta_neg, n)
    expelbo_rec = torch.exp(-2.0 * scale * (h.beta_rec * sq_err(rec, rec_rec) + kl_rec)).mean()
    expelbo_fake = torch.exp(-2.0 * scale * (h.beta_rec * sq_err(fake, rec_fake)
                                             + kl_fake)).mean()
    loss_e = scale * (loss_rec + kl_real) + 0.25 * (expelbo_rec + expelbo_fake)
    names_e = list(pe)
    grads_e = dict(zip(names_e, torch.autograd.grad(loss_e, [pe[k] for k in names_e])))
    opt_e.update(params, grads_e)
    z = z.detach()
    del fake, rec, rec_rec, rec_fake, mu, logvar, rec_mu, rec_logvar, fake_mu, fake_logvar

    # ---- the decoder phase, with the encoder the first phase updated
    pe = {k: v.detach() for k, v in split(params)[0].items()}
    pd = {k: v.detach().requires_grad_(True) for k, v in split(params)[1].items()}
    fake = decoder(pd, arch, noise["prior"], q)
    rec = decoder(pd, arch, z, q)
    loss_rec_d = h.beta_rec * sq_err(x, rec).mean()
    rec_mu, rec_logvar = encoder(pe, arch, rec, q)
    z_rec = rec_mu + noise["rec_d"] * torch.exp(0.5 * rec_logvar)
    fake_mu, fake_logvar = encoder(pe, arch, fake, q)
    z_fake = fake_mu + noise["fake_d"] * torch.exp(0.5 * fake_logvar)
    rec_rec = decoder(pd, arch, z_rec.detach(), q)
    rec_fake = decoder(pd, arch, z_fake.detach(), q)
    beta_rr = h.gamma_r * h.beta_rec
    loss_rr = beta_rr * sq_err(rec, rec_rec).mean()
    loss_fr = beta_rr * sq_err(fake, rec_fake).mean()
    kl_r = kl_site(z_rec, rec_mu, rec_logvar, h.beta_kl, n).mean()
    kl_f = kl_site(z_fake, fake_mu, fake_logvar, h.beta_kl, n).mean()
    loss_d = scale * (loss_rec_d + 0.5 * (kl_r + kl_f) + 0.5 * (loss_rr + loss_fr))
    names_d = list(pd)
    grads_d = dict(zip(names_d, torch.autograd.grad(loss_d, [pd[k] for k in names_d])))
    opt_d.update(params, grads_d)
    return {"loss_enc": loss_e.detach(), "loss_dec": loss_d.detach(),
            "grads_e": grads_e, "grads_d": grads_d}
