"""The paper's CNN benchmark family (port of ``repro/cnn/models.py``):
ResNet18 (TinyImageNet-modified), VGG16, MobileNetV2 — all built on the
quantized conv/linear engine so the estimator studies (Tables 1-3) run
unchanged.

Configs are width/size parametrized: the ``*_TINY`` variants are the
paper's Tiny ImageNet models at full width (64 x 64 x 3 images, 200
classes, stride-1 stems); ``bench_config`` gives scaled variants.

API (functional, mirrors ``repro_torch.models.model``)::

    params, bn_state = init(cfg, seed, device)     # ParamTree, dict
    sites            = init_sites(cfg, device=device)
    logits, new_bn, stats = apply_cfg(cfg, params, bn_state, sites,
                                      images, policy, seed, step)

Parameters are a :class:`~repro_torch.models.param_tree.ParamTree` with
the reference's nesting (``params["b3"]["dw"]``); the BN running
statistics and the quant sites are nested dicts of tensors.  Activations
are NHWC and kernels HWIO, as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core import qlinear
from repro_torch.core.policy import QuantPolicy
from repro_torch.device import resolve_device
from repro_torch.models.param_tree import ParamTree
from repro_torch.telemetry import metrics

from . import layers as L


@dataclasses.dataclass(frozen=True)
class CNNConfig:
    name: str
    arch: str                  # resnet18 | vgg16 | mobilenetv2
    num_classes: int = 200
    width: float = 1.0
    image_size: int = 64
    channels: int = 3

    def scaled(self, c: int) -> int:
        return max(8, int(c * self.width + 0.5) // 8 * 8)


RESNET18_TINY = CNNConfig("resnet18-tiny", "resnet18")      # Sun 2017 variant
VGG16_TINY = CNNConfig("vgg16-tiny", "vgg16")
MOBILENETV2_TINY = CNNConfig("mobilenetv2-tiny", "mobilenetv2")


def bench_config(arch: str, num_classes=10, width=0.25, image_size=32):
    return CNNConfig(f"{arch}-bench", arch, num_classes, width, image_size)


def _fc_init(gen: torch.Generator, cin: int, classes: int) -> torch.Tensor:
    return torch.randn((cin, classes), generator=gen,
                       device=gen.device) * cin ** -0.5


def _qfc(x, w, site, policy, seed, step):
    xq, in_stats, xqi = qlinear.act_quant_site(x, site["act"], policy, step)
    y, s = qlinear.qdense_pre(xq, w, site, policy, seed=seed, step=step,
                              qinfo=xqi)
    s["act"] = in_stats
    return y.to(torch.float32), s


# ===========================================================================
# ResNet18 (modified for 64x64: 3x3 stem, no max-pool — Sun 2017).
# ===========================================================================
_RESNET_STAGES = ((64, 2, 1), (128, 2, 2), (256, 2, 2), (512, 2, 2))


def _init_resnet(gen, cfg: CNNConfig):
    dev = gen.device
    params, bn = {}, {}
    cin = cfg.channels
    c0 = cfg.scaled(64)
    params["stem"] = L.init_conv(gen, 3, 3, cin, c0)
    params["stem_bn"], bn["stem_bn"] = L.init_bn(c0, dev)
    cin = c0
    for si, (c, blocks, stride) in enumerate(_RESNET_STAGES):
        c = cfg.scaled(c)
        for bi in range(blocks):
            s = stride if bi == 0 else 1
            blk = {"conv1": L.init_conv(gen, 3, 3, cin, c),
                   "conv2": L.init_conv(gen, 3, 3, c, c)}
            bnb = {}
            blk["bn1"], bnb["bn1"] = L.init_bn(c, dev)
            blk["bn2"], bnb["bn2"] = L.init_bn(c, dev)
            if s != 1 or cin != c:
                blk["proj"] = L.init_conv(gen, 1, 1, cin, c)
                blk["proj_bn"], bnb["proj_bn"] = L.init_bn(c, dev)
            params[f"s{si}b{bi}"] = blk
            bn[f"s{si}b{bi}"] = bnb
            cin = c
    params["fc"] = _fc_init(gen, cin, cfg.num_classes)
    return params, bn


def _resnet_sites(cfg: CNNConfig, device):
    site = lambda: qlinear.init_site(device=device)     # noqa: E731
    sites = {"stem": site(), "fc": site()}
    cin = cfg.scaled(64)
    for si, (c, blocks, stride) in enumerate(_RESNET_STAGES):
        c = cfg.scaled(c)
        for bi in range(blocks):
            s = stride if bi == 0 else 1
            d = {"conv1": site(), "conv2": site()}
            if s != 1 or cin != c:
                d["proj"] = site()
            sites[f"s{si}b{bi}"] = d
            cin = c
    return sites


def _apply_resnet(params, bn, sites, x, policy, seed, step, train):
    stats, new_bn = {}, {}
    x, stats["stem"] = L.qconv(x, params["stem"], sites["stem"], policy,
                               seed=seed, step=step)
    x, new_bn["stem_bn"] = L.batchnorm(x, params["stem_bn"], bn["stem_bn"],
                                       train=train)
    x = torch.relu(x)
    si_seed = seed
    for si, (c, blocks, stride) in enumerate(_RESNET_STAGES):
        for bi in range(blocks):
            name = f"s{si}b{bi}"
            blk, bnb, sb = params[name], bn[name], sites[name]
            s = stride if bi == 0 else 1
            si_seed = si_seed + 16
            h, st1 = L.qconv(x, blk["conv1"], sb["conv1"], policy,
                             seed=si_seed, step=step, stride=s)
            h, nb1 = L.batchnorm(h, blk["bn1"], bnb["bn1"], train=train)
            h = torch.relu(h)
            h, st2 = L.qconv(h, blk["conv2"], sb["conv2"], policy,
                             seed=si_seed + 1, step=step)
            h, nb2 = L.batchnorm(h, blk["bn2"], bnb["bn2"], train=train)
            sc = x
            nstats = {"conv1": st1, "conv2": st2}
            nbn = {"bn1": nb1, "bn2": nb2}
            if blk.get("proj") is not None:
                sc, stp = L.qconv(x, blk["proj"], sb["proj"], policy,
                                  seed=si_seed + 2, step=step, stride=s)
                sc, nbp = L.batchnorm(sc, blk["proj_bn"], bnb["proj_bn"],
                                      train=train)
                nstats["proj"] = stp
                nbn["proj_bn"] = nbp
            x = torch.relu(h + sc)
            stats[name] = nstats
            new_bn[name] = nbn
    x = L.avgpool_global(x)
    logits, stats["fc"] = _qfc(x, params["fc"], sites["fc"], policy,
                               seed + 999, step)
    return logits, new_bn, stats


# ===========================================================================
# VGG16.
# ===========================================================================
_VGG_PLAN = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))


def _init_vgg(gen, cfg: CNNConfig):
    params, bn = {}, {}
    cin = cfg.channels
    for si, (c, n) in enumerate(_VGG_PLAN):
        c = cfg.scaled(c)
        for bi in range(n):
            params[f"c{si}_{bi}"] = L.init_conv(gen, 3, 3, cin, c)
            params[f"bn{si}_{bi}"], bn[f"bn{si}_{bi}"] = L.init_bn(
                c, gen.device)
            cin = c
    params["fc"] = _fc_init(gen, cin, cfg.num_classes)
    return params, bn


def _vgg_sites(cfg: CNNConfig, device):
    sites = {"fc": qlinear.init_site(device=device)}
    for si, (c, n) in enumerate(_VGG_PLAN):
        for bi in range(n):
            sites[f"c{si}_{bi}"] = qlinear.init_site(device=device)
    return sites


def _apply_vgg(params, bn, sites, x, policy, seed, step, train):
    stats, new_bn = {}, {}
    for si, (c, n) in enumerate(_VGG_PLAN):
        for bi in range(n):
            name = f"c{si}_{bi}"
            seed = seed + 8
            x, stats[name] = L.qconv(x, params[name], sites[name], policy,
                                     seed=seed, step=step)
            x, new_bn[f"bn{si}_{bi}"] = L.batchnorm(
                x, params[f"bn{si}_{bi}"], bn[f"bn{si}_{bi}"], train=train)
            x = torch.relu(x)
        if x.shape[1] > 1:
            x = L.maxpool(x)
    x = L.avgpool_global(x)
    logits, stats["fc"] = _qfc(x, params["fc"], sites["fc"], policy,
                               seed + 999, step)
    return logits, new_bn, stats


# ===========================================================================
# MobileNetV2 (inverted residuals; depthwise = grouped qconv).
# ===========================================================================
_MBV2_PLAN = (  # (expansion, out, blocks, stride)
    (1, 16, 1, 1), (6, 24, 2, 1), (6, 32, 3, 2), (6, 64, 4, 2),
    (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1))


def _init_mbv2(gen, cfg: CNNConfig):
    dev = gen.device
    params, bn = {}, {}
    c0 = cfg.scaled(32)
    params["stem"] = L.init_conv(gen, 3, 3, cfg.channels, c0)
    params["stem_bn"], bn["stem_bn"] = L.init_bn(c0, dev)
    cin = c0
    idx = 0
    for t, c, n, s in _MBV2_PLAN:
        c = cfg.scaled(c)
        for bi in range(n):
            mid = cin * t
            blk, bnb = {}, {}
            if t != 1:
                blk["expand"] = L.init_conv(gen, 1, 1, cin, mid)
                blk["expand_bn"], bnb["expand_bn"] = L.init_bn(mid, dev)
            blk["dw"] = L.init_conv(gen, 3, 3, mid, mid, groups=mid)
            blk["dw_bn"], bnb["dw_bn"] = L.init_bn(mid, dev)
            blk["project"] = L.init_conv(gen, 1, 1, mid, c)
            blk["project_bn"], bnb["project_bn"] = L.init_bn(c, dev)
            params[f"b{idx}"] = blk
            bn[f"b{idx}"] = bnb
            idx += 1
            cin = c
    chead = cfg.scaled(1280)
    params["head"] = L.init_conv(gen, 1, 1, cin, chead)
    params["head_bn"], bn["head_bn"] = L.init_bn(chead, dev)
    params["fc"] = _fc_init(gen, chead, cfg.num_classes)
    return params, bn


def _mbv2_sites(cfg: CNNConfig, device):
    site = lambda: qlinear.init_site(device=device)     # noqa: E731
    sites = {"stem": site(), "head": site(), "fc": site()}
    idx = 0
    for t, c, n, s in _MBV2_PLAN:
        for bi in range(n):
            d = {"dw": site(), "project": site()}
            if t != 1:
                d["expand"] = site()
            sites[f"b{idx}"] = d
            idx += 1
    return sites


def _apply_mbv2(params, bn, sites, x, policy, seed, step, train):
    stats, new_bn = {}, {}
    x, stats["stem"] = L.qconv(x, params["stem"], sites["stem"], policy,
                               seed=seed, step=step, stride=1)
    x, new_bn["stem_bn"] = L.batchnorm(x, params["stem_bn"], bn["stem_bn"],
                                       train=train)
    x = F.relu6(x)
    idx = 0
    for t, c, n, s0 in _MBV2_PLAN:
        for bi in range(n):
            name = f"b{idx}"
            blk, bnb, sb = params[name], bn[name], sites[name]
            s = s0 if bi == 0 else 1
            seed = seed + 16
            h = x
            nstats, nbn = {}, {}
            if blk.get("expand") is not None:
                h, nstats["expand"] = L.qconv(h, blk["expand"], sb["expand"],
                                              policy, seed=seed, step=step)
                h, nbn["expand_bn"] = L.batchnorm(h, blk["expand_bn"],
                                                  bnb["expand_bn"],
                                                  train=train)
                h = F.relu6(h)
            mid = h.shape[-1]
            h, nstats["dw"] = L.qconv(h, blk["dw"], sb["dw"], policy,
                                      seed=seed + 1, step=step, stride=s,
                                      groups=mid)
            h, nbn["dw_bn"] = L.batchnorm(h, blk["dw_bn"], bnb["dw_bn"],
                                          train=train)
            h = F.relu6(h)
            h, nstats["project"] = L.qconv(h, blk["project"], sb["project"],
                                           policy, seed=seed + 2, step=step)
            h, nbn["project_bn"] = L.batchnorm(h, blk["project_bn"],
                                               bnb["project_bn"], train=train)
            if s == 1 and h.shape[-1] == x.shape[-1]:
                h = h + x
            x = h
            stats[name] = nstats
            new_bn[name] = nbn
            idx += 1
    x, stats["head"] = L.qconv(x, params["head"], sites["head"], policy,
                               seed=seed + 3, step=step)
    x, new_bn["head_bn"] = L.batchnorm(x, params["head_bn"], bn["head_bn"],
                                       train=train)
    x = F.relu6(x)
    x = L.avgpool_global(x)
    logits, stats["fc"] = _qfc(x, params["fc"], sites["fc"], policy,
                               seed + 999, step)
    return logits, new_bn, stats


# ===========================================================================
# Dispatch.
# ===========================================================================
_FAMILIES = {
    "resnet18": (_init_resnet, _resnet_sites, _apply_resnet),
    "vgg16": (_init_vgg, _vgg_sites, _apply_vgg),
    "mobilenetv2": (_init_mbv2, _mbv2_sites, _apply_mbv2),
}


def init(cfg: CNNConfig, seed: int = 0, device=None):
    """``(params, bn_state)``: random parameters from a seeded
    ``torch.Generator`` on ``device`` (the card unless ``"cpu"``)."""
    gen = torch.Generator(device=resolve_device(device)).manual_seed(
        int(seed))
    params, bn = _FAMILIES[cfg.arch][0](gen, cfg)
    return ParamTree(params), bn


def init_sites(cfg: CNNConfig, policy: Optional[QuantPolicy] = None,
               device=None) -> dict:
    """The quant sites (width 3, widened when ``policy`` has telemetry
    enabled) on ``device``."""
    sites = _FAMILIES[cfg.arch][1](cfg, resolve_device(device))
    if policy is not None:
        sites = metrics.widen_state(sites, policy.stat_width)
    return sites


def apply_cfg(cfg: CNNConfig, params, bn_state, sites, images,
              policy: QuantPolicy, seed, step, train: bool = True):
    return _FAMILIES[cfg.arch][2](params, bn_state, sites, images, policy,
                                  int(seed), step, train)


def loss_fn(cfg: CNNConfig, params, bn_state, quant_state, batch,
            policy: QuantPolicy, seed, step, train: bool = True):
    """Cross-entropy; returns ``(loss, (new_bn, stats, metrics))``."""
    logits, new_bn, stats = apply_cfg(cfg, params, bn_state, quant_state,
                                      batch["images"], policy, seed, step,
                                      train)
    labels = batch["labels"]
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, 1, labels[:, None])[:, 0]
    loss = torch.mean(logz - gold)
    acc = torch.mean((torch.argmax(logits, -1) == labels).to(torch.float32))
    return loss, (new_bn, stats, {"acc": acc.detach()})
