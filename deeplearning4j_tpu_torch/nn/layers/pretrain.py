"""Pretraining layers: the denoising AutoEncoder, the RecursiveAutoEncoder
and the RBM (contrastive divergence), on tensors.

Port of ``deeplearning4j_tpu/nn/layers/pretrain.py`` (the reference's
AutoEncoder.java and RBM.java:68, contrastiveDivergence :101,
sampleHiddenGivenVisible :225, propUp/propDown :226,284).

The reference draws its Gibbs samples from explicit ``jax.random`` keys;
torch cannot reproduce those streams. So every sampling method here takes
either a ``torch.Generator`` or the draws themselves (``draws=``): the
uniforms a binary unit compares its mean against (``jax.random.bernoulli``
is ``uniform < p``), or the standard normals a Gaussian unit adds to its
mean. Fed the same draws, the port and the reference take the same
samples. CD-k consumes ``2k + 1`` draws in the reference's key order: the
first hidden sample, then a visible and a hidden draw per Gibbs step.

The CD update is not the gradient of a tractable loss, so the RBM exposes
``pretrain_grads`` directly; the AutoEncoders expose ``pretrain_loss``,
which autograd differentiates.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.conf.enums import HiddenUnit, VisibleUnit
from deeplearning4j_tpu_torch.nn.layers.base import (
    LayerImpl,
    Params,
    register_layer_impl,
)
from deeplearning4j_tpu_torch.ops.initializers import init_weights
from deeplearning4j_tpu_torch.ops.losses import compute_loss

Draws = Optional[Sequence[Optional[torch.Tensor]]]


def _draw(kind: str, shape, like: torch.Tensor,
          generator: Optional[torch.Generator]) -> torch.Tensor:
    """A uniform (``kind`` "uniform") or standard normal draw of ``shape``
    on ``like``'s device and dtype, from ``generator``."""
    if generator is None:
        raise ValueError("sampling needs a torch.Generator or draws=")
    fn = torch.rand if kind == "uniform" else torch.randn
    return fn(tuple(shape), generator=generator, dtype=like.dtype,
              device=like.device)


@register_layer_impl(L.AutoEncoder)
class AutoEncoderImpl(LayerImpl):
    """Encoder ``y = act(xW + b)``; decoder ``z = act(yWᵀ + vb)`` (tied
    weights: the reference's params W, b, vb)."""

    def param_shapes(self):
        c = self.conf
        return {"W": (c.n_in, c.n_out), "b": (c.n_out,), "vb": (c.n_in,)}

    def init_params(self, gen):
        c, dt = self.conf, self.policy.param_dtype
        return {
            "W": init_weights(gen, (c.n_in, c.n_out), c.weight_init.value,
                              distribution=c.dist, dtype=dt),
            "b": torch.full((c.n_out,), c.bias_init, dtype=dt),
            "vb": torch.zeros((c.n_in,), dtype=dt),
        }

    def forward(self, params, x, state, *, train=False, rng=None, mask=None):
        x = self.maybe_dropout(x, train=train, rng=rng)
        return self.activation_fn()(x @ params["W"] + params["b"]), state

    def decode(self, params, y):
        return self.activation_fn()(y @ params["W"].T + params["vb"])

    def pretrain_loss(self, params, x, generator=None, draws: Draws = None):
        """Denoising reconstruction loss: corrupt, encode, decode, score
        against the clean input. ``draws[0]`` (or the generator) gives the
        corruption mask's uniforms: an input is kept where its draw is
        below ``1 - corruption_level``."""
        level = self.conf.corruption_level
        if level > 0:
            u = (draws[0] if draws is not None
                 else _draw("uniform", x.shape, x, generator))
            xc = torch.where(u < 1.0 - level, x, 0.0)
        else:
            xc = x
        y = self.activation_fn()(xc @ params["W"] + params["b"])
        return compute_loss(self.conf.loss_function, self.decode(params, y),
                            x)


@register_layer_impl(L.RecursiveAutoEncoder)
class RecursiveAutoEncoderImpl(LayerImpl):
    """Recursive autoencoder (RecursiveAutoEncoder.java).

    Folds a sequence left to right from a zero root: p₀ = 0;
    pᵢ = act([pᵢ₋₁; xᵢ]·W_e + b_e), with the reconstruction
    [p̂; x̂] = act(pᵢ·W_d + b_d) scored against [pᵢ₋₁; xᵢ] under the
    layer's ``loss_function``. Masked timesteps hold the carry and add no
    loss. Forward returns the root; rank-2 inputs are length-1 sequences.
    """

    def param_shapes(self):
        d_in, d = self.conf.n_in, self.conf.n_out
        return {"We": (d + d_in, d), "be": (d,), "Wd": (d, d + d_in),
                "bd": (d + d_in,)}

    def init_params(self, gen):
        c, dt = self.conf, self.policy.param_dtype
        d_in, d = c.n_in, c.n_out
        We = init_weights(gen, (d + d_in, d), c.weight_init.value,
                          distribution=c.dist, dtype=dt)
        Wd = init_weights(gen, (d, d + d_in), c.weight_init.value,
                          distribution=c.dist, dtype=dt)
        return {"We": We, "be": torch.full((d,), c.bias_init, dtype=dt),
                "Wd": Wd, "bd": torch.zeros((d + d_in,), dtype=dt)}

    def _fold(self, params, x, mask=None):
        """x ``[b, t, n_in]``, mask ``[b, t]`` or None → (root ``[b,
        n_out]``, mean per-step reconstruction loss over unmasked steps)."""
        act = self.activation_fn()
        batch, t = x.shape[0], x.shape[1]
        p = x.new_zeros((batch, self.conf.n_out))
        mask_t = (x.new_ones((t, batch)) if mask is None
                  else mask.to(x.dtype).transpose(0, 1))
        recons, ccs = [], []
        for s in range(t):
            cc = torch.cat([p, x[:, s]], dim=-1)
            p_new = act(cc @ params["We"] + params["be"])
            recons.append(act(p_new @ params["Wd"] + params["bd"]))
            ccs.append(cc)
            p = torch.where(mask_t[s][:, None] > 0, p_new, p)
        feat = recons[0].shape[-1]
        loss = compute_loss(
            self.conf.loss_function, torch.stack(recons).reshape(-1, feat),
            torch.stack(ccs).reshape(-1, feat), mask=mask_t.reshape(-1))
        return p, loss

    def forward(self, params, x, state, *, train=False, rng=None, mask=None):
        x = self.maybe_dropout(x, train=train, rng=rng)
        if x.ndim == 2:
            x, mask = x[:, None, :], None
        root, _ = self._fold(params, x, mask=mask)
        return root, state

    def pretrain_loss(self, params, x, generator=None, draws: Draws = None,
                      mask=None):
        if x.ndim == 2:
            x, mask = x[:, None, :], None
        return self._fold(params, x, mask=mask)[1]


@register_layer_impl(L.RBM)
class RBMImpl(LayerImpl):
    def param_shapes(self):
        c = self.conf
        return {"W": (c.n_in, c.n_out), "hb": (c.n_out,), "vb": (c.n_in,)}

    def init_params(self, gen):
        c, dt = self.conf, self.policy.param_dtype
        return {
            "W": init_weights(gen, (c.n_in, c.n_out), c.weight_init.value,
                              distribution=c.dist, dtype=dt),
            "hb": torch.zeros((c.n_out,), dtype=dt),
            "vb": torch.zeros((c.n_in,), dtype=dt),
        }

    # propUp (RBM.java:226)
    def prop_up(self, params, v):
        return self._hidden_activation(v @ params["W"] + params["hb"])

    # propDown (RBM.java:284)
    def prop_down(self, params, h):
        return self._visible_activation(h @ params["W"].T + params["vb"])

    def _hidden_activation(self, pre):
        hu = self.conf.hidden_unit
        if hu == HiddenUnit.BINARY:
            return torch.sigmoid(pre)
        if hu == HiddenUnit.RECTIFIED:
            return torch.relu(pre)
        if hu == HiddenUnit.GAUSSIAN:
            return pre
        if hu == HiddenUnit.SOFTMAX:
            return torch.softmax(pre, dim=-1)
        raise ValueError(hu)

    def _visible_activation(self, pre):
        vu = self.conf.visible_unit
        if vu == VisibleUnit.BINARY:
            return torch.sigmoid(pre)
        if vu in (VisibleUnit.GAUSSIAN, VisibleUnit.LINEAR):
            return pre
        if vu == VisibleUnit.SOFTMAX:
            return torch.softmax(pre, dim=-1)
        raise ValueError(vu)

    @staticmethod
    def _draw_kind(binary: bool, gaussian: bool) -> Optional[str]:
        return "uniform" if binary else "normal" if gaussian else None

    def _sample(self, mean, kind, draw, generator):
        """Binary: ``draw < mean``; Gaussian: ``mean + draw``; otherwise
        mean-field (the draw is unused)."""
        if kind is None:
            return mean
        if draw is None:
            draw = _draw(kind, mean.shape, mean, generator)
        if kind == "uniform":
            return (draw < mean).to(mean.dtype)
        return mean + draw

    def _hidden_kind(self):
        hu = self.conf.hidden_unit
        return self._draw_kind(hu == HiddenUnit.BINARY,
                               hu == HiddenUnit.GAUSSIAN)

    def _visible_kind(self):
        vu = self.conf.visible_unit
        return self._draw_kind(vu == VisibleUnit.BINARY,
                               vu == VisibleUnit.GAUSSIAN)

    def sample_hidden(self, params, v, draw=None, generator=None):
        mean = self.prop_up(params, v)
        return mean, self._sample(mean, self._hidden_kind(), draw, generator)

    def sample_visible(self, params, h, draw=None, generator=None):
        mean = self.prop_down(params, h)
        return mean, self._sample(mean, self._visible_kind(), draw, generator)

    def draw_shapes(self, batch: int) -> List[Tuple[Optional[str], tuple]]:
        """(kind, shape) of each of CD-k's ``2k + 1`` draws, in the order
        ``pretrain_grads`` consumes them; kind None means unused."""
        k = max(1, int(self.conf.k))
        h = (self._hidden_kind(), (batch, self.conf.n_out))
        v = (self._visible_kind(), (batch, self.conf.n_in))
        return [h] + [v, h] * k

    def gibbs_chain(self, params, v0, generator=None, draws: Draws = None):
        """CD-k's chain from ``v0``: the first hidden sample, then per step
        ``(v_mean, v_sample, h_mean, h_sample)``."""
        k = max(1, int(self.conf.k))
        d = list(draws) if draws is not None else [None] * (2 * k + 1)
        if len(d) != 2 * k + 1:
            raise ValueError(f"CD-{k} takes {2 * k + 1} draws, got {len(d)}")
        _, h0_s = self.sample_hidden(params, v0, d[0], generator)
        h_s, steps = h0_s, []
        for j in range(k):
            v_mean, v_s = self.sample_visible(params, h_s, d[1 + 2 * j],
                                              generator)
            h_mean, h_s = self.sample_hidden(params, v_s, d[2 + 2 * j],
                                             generator)
            steps.append((v_mean, v_s, h_mean, h_s))
        return h0_s, steps

    def forward(self, params, x, state, *, train=False, rng=None, mask=None):
        x = self.maybe_dropout(x, train=train, rng=rng)
        return self.prop_up(params, x), state

    def pretrain_grads(self, params, v0, generator=None, draws: Draws = None
                       ) -> Tuple[Params, torch.Tensor]:
        """CD-k gradients (RBM.java contrastiveDivergence :101) and the
        reconstruction error. The grads are to be descended:
        ``-(positive phase - negative phase) / batch``."""
        batch = v0.shape[0]
        h0_mean = self.prop_up(params, v0)
        _, steps = self.gibbs_chain(params, v0, generator, draws)
        vk_mean, vk_sample, hk_mean, _ = steps[-1]
        inv_b = 1.0 / float(batch)
        gW = -(v0.T @ h0_mean - vk_sample.T @ hk_mean) * inv_b
        ghb = -torch.mean(h0_mean - hk_mean, dim=0)
        gvb = -torch.mean(v0 - vk_sample, dim=0)
        score = torch.mean(torch.sum((v0 - vk_mean) ** 2, dim=-1))
        return {"W": gW, "hb": ghb, "vb": gvb}, score

    def pretrain_loss(self, params, x, generator=None, draws: Draws = None):
        return self.pretrain_grads(params, x, generator, draws)[1]

    def free_energy(self, params, v):
        """F(v) = -vb·v - Σ softplus(vW + hb) (binary units)."""
        wx_b = v @ params["W"] + params["hb"]
        return -v @ params["vb"] - torch.sum(
            torch.nn.functional.softplus(wx_b), dim=-1)
