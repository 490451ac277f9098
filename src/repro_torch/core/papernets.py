"""The paper's own evaluation networks and the P->Q / Q->P training
harness, torch port of ``repro.core.papernets``.

Models (``configs/paper.py``):
  mlp1    : Linear(784 -> 10), the Fig 2 overflow census;
  mlp2    : 784 x 784 hidden + 784 x 10 head, the Fig 3 study;
  convnet : two stride-2 3 x 3 convs (im2col + QuantLinear) and a head,
            the CIFAR-scale stand-in for Figs 4 and 5.

Every layer is a ``core.pqs`` QuantLinear, so a trained net drops
straight into the overflow census and the narrow-accumulator integer
path (``evaluate_int``: the CUDA kernels of ``dispatch.pqs_dot`` on the
card). Training is plain SGD with momentum on softmax cross-entropy, by
``torch.matmul`` and autograd, as the JAX package trains with ``x @ w.T``
and ``jax.value_and_grad`` outside its kernels; the epochs follow
``core.pqs.build_schedule``.

Entry points run on the device of the layers they are given;
``train_papernet`` draws its layers on ``device`` (CUDA unless the caller
asks for the CPU) from a ``torch.Generator`` seeded with ``seed``, or
takes them as ``layers=`` (the one difference from the JAX signature:
tests start both packages from the same converted layers).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.configs.paper import PaperNetConfig
from repro_torch.core import overflow
from repro_torch.core.a2q import a2q_fake_quant
from repro_torch.core.pqs import (
    PQSConfig,
    apply_prune_phase,
    build_schedule,
    quant_linear_census,
    quant_linear_freeze,
    quant_linear_init,
    quant_linear_int_fwd,
    quant_linear_train_fwd,
)
from repro_torch.core.pruning import filter_prune_mask, low_rank_approx
from repro_torch.core.quant import EmaRange
from repro_torch.data.pipeline import ClassificationDataset

# ---------------------------------------------------------------------------
# model definitions (lists of QuantLinear layers + structure fns)
# ---------------------------------------------------------------------------


def _same_pads(n: int, stride: int, window: int = 3) -> tuple[int, int]:
    """XLA's "SAME" padding (low, high) of one spatial axis: the output
    is ceil(n / stride), and an odd total puts the extra row after."""
    out = -(-n // stride)
    total = max((out - 1) * stride + window - n, 0)
    return total // 2, total - total // 2


def _img_patches(x: torch.Tensor, hw: int, cin: int, stride: int = 2):
    """im2col: (B, hw*hw*cin) NHWC -> (B, oh*ow, cin*3*3) patches, the
    features channel-major (cin, kh, kw), as
    ``jax.lax.conv_general_dilated_patches`` with "SAME" lays them out
    (its padding is (0, 1) at 14 x 14 and (1, 1) at 7 x 7)."""
    b = x.shape[0]
    img = x.reshape(b, hw, hw, cin).permute(0, 3, 1, 2)
    lo, hi = _same_pads(hw, stride)
    img = F.pad(img, (lo, hi, lo, hi))
    patches = F.unfold(img, (3, 3), stride=stride)  # (B, cin*9, oh*ow)
    oh = ow = -(-hw // stride)
    return patches.transpose(1, 2), oh, ow


def init_papernet(gen: torch.Generator, cfg: PaperNetConfig
                  ) -> list[dict[str, Any]]:
    """The net's layers on the generator's device."""
    if cfg.kind == "mlp1":
        return [quant_linear_init(gen, cfg.in_dim, cfg.num_classes)]
    if cfg.kind == "mlp2":
        return [quant_linear_init(gen, cfg.in_dim, cfg.hidden),
                quant_linear_init(gen, cfg.hidden, cfg.num_classes)]
    if cfg.kind == "convnet":
        c1, c2 = cfg.channels
        cin = cfg.in_dim // (cfg.img_hw * cfg.img_hw)
        oh1 = (cfg.img_hw + 1) // 2  # stride-2 SAME conv output size
        oh2 = (oh1 + 1) // 2
        return [
            quant_linear_init(gen, 9 * cin, c1),  # conv1 as im2col matmul
            quant_linear_init(gen, 9 * c1, c2),  # conv2
            quant_linear_init(gen, oh2 * oh2 * c2, cfg.num_classes),
        ]
    raise ValueError(cfg.kind)


def pqs_layer_mask(cfg: PaperNetConfig) -> list[bool]:
    """Which layers are pruned and quantized: paper section 5.0.2 skips
    the first conv and the classifier head of CNNs; MLPs prune their
    hidden layer only."""
    if cfg.kind == "mlp1":
        return [True]
    if cfg.kind == "mlp2":
        return [True, False]
    return [False, True, False]


def papernet_fwd(
    layers: list[dict],
    x: torch.Tensor,
    cfg: PaperNetConfig,
    pqs: PQSConfig,
    quantizing: bool,
    int_path: bool = False,
    frozen: Optional[list] = None,
    policy: Optional[str] = None,
    acc_bits: Optional[int] = None,
) -> tuple[torch.Tensor, list[dict]]:
    """Forward through the net. The training path updates the activation
    observers; the integer path runs the frozen layers under (policy,
    acc_bits)."""
    layers = list(layers)

    def layer(i, h):
        if int_path:
            c = dataclasses.replace(pqs, policy=policy or pqs.policy,
                                    acc_bits=acc_bits or pqs.acc_bits)
            return quant_linear_int_fwd(frozen[i], h, c)
        out, layers[i] = quant_linear_train_fwd(layers[i], h, pqs,
                                                quantizing)
        return out

    if cfg.kind in ("mlp1", "mlp2"):
        h = x
        for i in range(len(layers)):
            h = layer(i, h)
            if i < len(layers) - 1:
                h = torch.relu(h)
        return h, layers

    # convnet: conv-as-im2col at stride 2 twice, then flatten + head
    cin = cfg.in_dim // (cfg.img_hw * cfg.img_hw)
    p1, oh, _ = _img_patches(x, cfg.img_hw, cin)
    h = torch.relu(layer(0, p1))  # (B, oh*ow, c1)
    h2, _, _ = _img_patches(h.reshape(h.shape[0], -1), oh, cfg.channels[0])
    h = torch.relu(layer(1, h2))  # (B, oh2*ow2, c2)
    h = h.reshape(h.shape[0], -1)
    return layer(2, h), layers


def ce_loss(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    return -torch.gather(logp, 1, y.to(torch.int64)[:, None]).mean()


# ---------------------------------------------------------------------------
# training harness
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TrainResult:
    layers: list[dict]
    fp32_acc: float
    history: list[tuple[int, float]]


def _detached(layer: dict) -> dict:
    out = dict(layer)
    for key in ("w", "b", "mask"):
        out[key] = layer[key].detach()
    rng = layer["act_range"]
    out["act_range"] = EmaRange(rng.lo.detach(), rng.hi.detach(), rng.decay,
                                rng.n)
    return out


def _device_of(layers: list[dict]) -> torch.device:
    return layers[0]["w"].device


def train_papernet(
    cfg: PaperNetConfig,
    pqs: PQSConfig,
    data: ClassificationDataset,
    epochs: int = 30,
    batch: int = 128,
    lr: float = 0.05,
    momentum: float = 0.9,
    prune_every: int = 5,
    fp32_frac: float = 0.7,
    low_rank: Optional[int] = None,
    a2q_acc_bits: Optional[int] = None,
    prune_kind: str = "nm",  # "nm" | "filter" (Fig 4 magenta baseline)
    seed: int = 0,
    *,
    layers: Optional[list[dict]] = None,
    device=None,
) -> TrainResult:
    """Run a full P->Q or Q->P schedule (pqs.order) on a paper net.

    low_rank: a rank-k approximation at each prune event (Fig 3).
    a2q_acc_bits: the A2Q weight constraint in place of PQS (baseline):
    each step's update lands on the projected weights, as in the JAX
    package. prune_kind: N:M (paper) or whole-filter pruning (baseline).
    layers: the starting layers (moved to ``device``); by default drawn
    from a ``torch.Generator`` seeded with ``seed``.
    """
    device = resolve_device(device)
    train, test = data.split(0.9)
    if layers is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        layers = init_papernet(gen, cfg)
    else:
        layers = [_detached(l) for l in to_device(layers, device)]
    mask = pqs_layer_mask(cfg)
    vel = [{"w": torch.zeros_like(l["w"]), "b": torch.zeros_like(l["b"])}
           for l in layers]
    schedule = build_schedule(pqs, epochs, prune_every, fp32_frac)

    def step(layers, vel, xb, yb, quantizing):
        ls = [dict(l, w=l["w"].requires_grad_(), b=l["b"].requires_grad_())
              for l in (_detached(l) for l in layers)]
        logits, new_ls = papernet_fwd(ls, xb, cfg, pqs, quantizing)
        loss = ce_loss(logits, yb)
        grads = torch.autograd.grad(
            loss, [t for l in ls for t in (l["w"], l["b"])])
        out_l, out_v = [], []
        with torch.no_grad():
            for i, (nl, v) in enumerate(zip(new_ls, vel)):
                nl = _detached(nl)
                if a2q_acc_bits is not None:
                    # A2Q regime: the weights are constrained, not pruned
                    nl["w"] = a2q_fake_quant(nl["w"], pqs.weight_bits,
                                             a2q_acc_bits)
                gw, gb = grads[2 * i], grads[2 * i + 1]
                nv = {"w": momentum * v["w"] + gw,
                      "b": momentum * v["b"] + gb}
                nl["w"] = nl["w"] - lr * nv["w"]
                nl["b"] = nl["b"] - lr * nv["b"]
                out_l.append(nl)
                out_v.append(nv)
        return out_l, out_v, loss.detach()

    history = []
    for ph in schedule:
        if ph.n_keep is not None:  # prune / low-rank events
            new_layers = []
            for i, l in enumerate(layers):
                if not mask[i]:
                    new_layers.append(l)
                    continue
                if low_rank is not None:
                    l = dict(l, w=low_rank_approx(l["w"], low_rank))
                if prune_kind == "filter":
                    keep_frac = ph.n_keep / pqs.m
                    new_layers.append(
                        dict(l, mask=filter_prune_mask(l["w"], keep_frac)))
                else:
                    new_layers.append(apply_prune_phase(
                        l, ph, pqs, quantized_signal=(pqs.order == "qp")))
            layers = new_layers
        for xb, yb in train.batches(batch, seed=seed * 997 + ph.epoch):
            layers, vel, loss = step(
                layers, vel, torch.from_numpy(xb).to(device),
                torch.from_numpy(yb).to(device), ph.quantizing)
        history.append((ph.epoch, float(loss)))

    acc = evaluate_fp32(layers, cfg, pqs, test)
    return TrainResult(layers, acc, history)


def to_device(layers: list[dict], device) -> list[dict]:
    """A net's layers (observers included) copied to ``device``."""
    out = []
    for layer in layers:
        rng = layer["act_range"]
        out.append({**{k: v.to(device) for k, v in layer.items()
                       if k != "act_range"},
                    "act_range": EmaRange(rng.lo.to(device),
                                          rng.hi.to(device), rng.decay,
                                          rng.n)})
    return out


@torch.no_grad()
def evaluate_fp32(layers, cfg, pqs: PQSConfig,
                  data: ClassificationDataset) -> float:
    dev = _device_of(layers)
    logits, _ = papernet_fwd(layers, torch.from_numpy(data.x).to(dev), cfg,
                             pqs, quantizing=False)
    pred = logits.argmax(-1).cpu().numpy()
    return float((pred == data.y).mean())


def freeze_net(layers, cfg, pqs: PQSConfig) -> list[dict]:
    mask = pqs_layer_mask(cfg)
    return [quant_linear_freeze(l, pqs if mask[i] else
                                dataclasses.replace(pqs, n_keep=pqs.m))
            for i, l in enumerate(layers)]


def evaluate_int(
    layers, cfg, pqs: PQSConfig, data: ClassificationDataset,
    policy: str, acc_bits: int, limit: int = 1024,
) -> float:
    """Accuracy with true integer matmuls under a narrow-register policy:
    ``dispatch.pqs_dot``, the CUDA kernels for layers on the card, the
    plain versions on the CPU."""
    frozen = freeze_net(layers, cfg, pqs)
    x = torch.from_numpy(data.x[:limit]).to(_device_of(layers))
    y = np.asarray(data.y[:limit])
    with torch.no_grad():
        logits, _ = papernet_fwd(layers, x, cfg, pqs, quantizing=False,
                                 int_path=True, frozen=frozen, policy=policy,
                                 acc_bits=acc_bits)
    return float((logits.argmax(-1).cpu().numpy() == y).mean())


@torch.no_grad()
def overflow_profile(
    layers, cfg, pqs: PQSConfig, data: ClassificationDataset,
    acc_bits: int, limit: int = 512,
) -> overflow.Census:
    """Persistent / transient census summed over the PQS layers (Fig 2a);
    the MLPs' layers, as in the JAX package."""
    frozen = freeze_net(layers, cfg, pqs)
    mask = pqs_layer_mask(cfg)
    tot = dict(n_dots=0, n_persistent=0, n_transient=0, n_any=0)
    x = torch.from_numpy(data.x[:limit]).to(_device_of(layers))
    h = x
    for i in range(len(layers)):
        if cfg.kind in ("mlp1", "mlp2"):
            if mask[i]:
                c = quant_linear_census(frozen[i], h, dataclasses.replace(
                    pqs, acc_bits=acc_bits))
                for k in tot:
                    tot[k] += int(getattr(c, k))
            h_out, _ = papernet_fwd(layers[: i + 1], x, cfg, pqs,
                                    quantizing=False)
            h = torch.relu(h_out) if i < len(layers) - 1 else h_out
    return overflow.Census(**{k: torch.tensor(v) for k, v in tot.items()})
