"""Embedding torsos: MLP, MinAtar CNN and Nature CNN (SURVEY.md §2 "Models").

Plain `jax.numpy`/`lax`. Each torso is a frozen dataclass with
`init(key, example_x) -> params` and `__call__(params, x) -> features`.
Params are float32 nested dicts: conv kernels HWIO, dense kernels
(in, out), LeCun-normal kernels and zero biases. Conv/dense compute
optionally runs in bfloat16 (params stay f32; features are cast back to
f32), which leaves the exact-numerics CPU test path, run with
compute_dtype=float32, untouched. Channel widths stay at the reference
capacities (Nature CNN 32/64/64 + FC-512) so learning-curve parity is
apples-to-apples.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import jax
import jax.numpy as jnp

_lecun_normal = jax.nn.initializers.lecun_normal()


def dense_params(key, d_in: int, d_out: int):
    return {"kernel": _lecun_normal(key, (d_in, d_out), jnp.float32),
            "bias": jnp.zeros((d_out,), jnp.float32)}


def dense(p, x, dtype):
    """x (..., d_in) @ kernel + bias, computed in `dtype`."""
    x = x.astype(dtype)
    return jnp.dot(x, p["kernel"].astype(dtype)) + p["bias"].astype(dtype)


def conv_params(key, k: int, c_in: int, c_out: int):
    return {"kernel": _lecun_normal(key, (k, k, c_in, c_out), jnp.float32),
            "bias": jnp.zeros((c_out,), jnp.float32)}


def conv(p, x, stride: int, dtype):
    """VALID NHWC conv with an HWIO kernel, computed in `dtype`."""
    y = jax.lax.conv_general_dilated(
        x.astype(dtype), p["kernel"].astype(dtype), (stride, stride),
        "VALID", dimension_numbers=("NHWC", "HWIO", "NHWC"))
    return y + p["bias"].astype(dtype)


def _conv_stack_params(key, in_shape, specs, fc: int):
    """Params for VALID convs `specs` = [(channels, kernel, stride)] on
    NHWC input `in_shape`, then a dense layer to `fc` features."""
    _, h, w, c = in_shape
    keys = jax.random.split(key, len(specs) + 1)
    params = {}
    for i, (ch, k, s) in enumerate(specs):
        params[f"Conv_{i}"] = conv_params(keys[i], k, c, ch)
        h, w, c = (h - k) // s + 1, (w - k) // s + 1, ch
    params["Dense_0"] = dense_params(keys[-1], h * w * c, fc)
    return params


def _conv_stack(params, x, specs, dtype):
    for i, (_, _, s) in enumerate(specs):
        x = jax.nn.relu(conv(params[f"Conv_{i}"], x, s, dtype))
    x = x.reshape(x.shape[0], -1)
    x = jax.nn.relu(dense(params["Dense_0"], x, dtype))
    return x.astype(jnp.float32)


@dataclasses.dataclass(frozen=True)
class MLPTorso:
    hidden: Sequence[int] = (64, 64)
    compute_dtype: Any = jnp.float32

    def _prep(self, x):
        return x.astype(self.compute_dtype).reshape(x.shape[0], -1)

    def init(self, key, x):
        d = jax.eval_shape(self._prep, x).shape[-1]
        keys = jax.random.split(key, len(self.hidden))
        params = {}
        for i, h in enumerate(self.hidden):
            params[f"Dense_{i}"] = dense_params(keys[i], d, h)
            d = h
        return params

    def __call__(self, params, x):
        x = self._prep(x)
        for i in range(len(self.hidden)):
            x = jax.nn.relu(dense(params[f"Dense_{i}"], x,
                                  self.compute_dtype))
        return x.astype(jnp.float32)


@dataclasses.dataclass(frozen=True)
class MinAtarCNNTorso:
    """MinAtar conv torso (Young & Tian 2019): 3x3/1 conv(s) + FC.

    Input: (B, H, W, C) binary planes (uint8 0/1 — cast, NOT /255), or
    (B, F, H, W, C) from the replay frame-window gather, in which case
    the frame axis is merged into channels (MinAtar uses F=1; the
    trail plane encodes motion).

    compute_dtype defaults to float32: the 10x10x16 convs are small,
    and whether bf16 pays back its casts here is a per-device
    measurement. (NatureCNNTorso, whose convs are big, defaults to
    bf16.)
    """
    channels: Sequence[int] = (16,)
    fc: int = 128
    compute_dtype: Any = jnp.float32

    def _specs(self):
        return [(ch, 3, 1) for ch in self.channels]

    def _prep(self, x):
        if x.ndim == 5:
            b, f, h, w, c = x.shape
            x = jnp.moveaxis(x, 1, -2).reshape(b, h, w, f * c)
        return x.astype(self.compute_dtype)

    def init(self, key, x):
        return _conv_stack_params(key, jax.eval_shape(self._prep, x).shape,
                                  self._specs(), self.fc)

    def __call__(self, params, x):
        return _conv_stack(params, self._prep(x), self._specs(),
                           self.compute_dtype)


@dataclasses.dataclass(frozen=True)
class NatureCNNTorso:
    """DeepMind Nature-DQN CNN: 8x8/4 -> 4x4/2 -> 3x3/1 -> FC 512.

    Input: (B, F, H, W) stacked uint8 frames or — with
    `channels_last` — (B, H, W, F) already conv-ready (the learner's
    NHWC union gather emits this directly, skipping the whole-batch
    relayout copy between gather and conv). Frames are normalized to
    [0, 1] on device (keeps the host->device stream uint8: 4x less
    memory traffic than shipping f32).

    `space_to_depth`: rewrite conv_0 (8x8 stride 4 on C channels) as
    an EXACT equivalent 2x2 stride 1 conv on 4x4-patched input with
    16*C channels — the same contraction (8*8*C = 2*2*16*C per output
    pixel, so lecun_normal fan-in and the function class are
    unchanged) but with a dense channel axis for the matrix units
    instead of a 4-channel im2col. Standard public trick (e.g. JAX
    MuZero / EfficientZero Atari pipelines). Param shapes change
    ((2,2,16C,32) vs (8,8,C,32)), so it is a config option, not a
    checkpoint-compatible toggle.
    """
    channels: Sequence[int] = (32, 64, 64)
    fc: int = 512
    compute_dtype: Any = jnp.bfloat16
    channels_last: bool = False
    space_to_depth: bool = False

    def _specs(self):
        kernels, strides = (8, 4, 3), (4, 2, 1)
        if self.space_to_depth:
            r = strides[0]
            kernels = (kernels[0] // r,) + kernels[1:]
            strides = (1,) + strides[1:]
        return list(zip(self.channels, kernels, strides))

    def _prep(self, x):
        if x.ndim == 4 and not self.channels_last:
            # (B, F, H, W) -> NHWC with frames as channels (layout ops
            # run on the raw uint8 bytes, before the f32/bf16 cast).
            x = jnp.transpose(x, (0, 2, 3, 1))
        if self.space_to_depth:
            b, h, w, c = x.shape
            r = 4   # conv_0 stride
            if h % r or w % r:
                raise ValueError(
                    "space_to_depth needs H, W divisible by conv_0 "
                    "stride")
            x = x.reshape(b, h // r, r, w // r, r, c)
            x = x.transpose(0, 1, 3, 2, 4, 5)
            x = x.reshape(b, h // r, w // r, r * r * c)
        if x.dtype == jnp.uint8:
            return x.astype(self.compute_dtype) / 255.0
        return x.astype(self.compute_dtype)

    def init(self, key, x):
        return _conv_stack_params(key, jax.eval_shape(self._prep, x).shape,
                                  self._specs(), self.fc)

    def __call__(self, params, x):
        return _conv_stack(params, self._prep(x), self._specs(),
                           self.compute_dtype)
