"""Recurrent layers: Graves LSTM (peepholes), LSTM, bidirectional LSTM,
GRU and ImageLSTM, on tensors.

Port of ``deeplearning4j_tpu/nn/layers/recurrent.py`` (the reference's
GravesLSTM.java, LSTMHelpers.java, GravesBidirectionalLSTM.java, GRU.java
and ImageLSTM.java). Each layer keeps the reference's shape of the work:

- the input projection of every timestep is one GEMM over
  ``[b·t, n_in]``, with the policy's casts where the reference puts them
  (``cast_output(cast_compute(x) @ cast_compute(W)) + b``);
- a Python loop over time runs the recurrence, ``cast_output(
  cast_compute(h) @ RW)`` and the gates, one step at a time; under
  ``bf16`` the GEMM operands are bf16 and the carry and all pointwise
  math f32. autograd derives the backward through the loop.

Params keep the reference's layouts (``W [n_in, 4n]``, ``RW [n, 4n]``,
``b [4n]``, peepholes ``pI``/``pF``/``pO [n]``; gate order ``[i, f, o,
g]``), so they carry over from the JAX package unpermuted. cuDNN's RNN
(``torch.nn.LSTM``/``GRU``) computes other functions: it has no
peepholes, orders the gates otherwise, applies GRU's reset gate after
the recurrent product, and knows neither masks nor the policy's casts.

Masks (variable-length series): at a masked step the carry ``(h, c)`` is
held and the output is zero, so padded steps change nothing. Without a
mask the blend is skipped (``1·x + 0·y`` is exactly ``x``). Layout is
``[batch, time, features]``.

Stateful use (TBPTT windows, ``rnn_time_step``): a layer threads ``h``
(and ``c``) when its state dict carries them, and returns the last
step's values under the same keys.
"""

from __future__ import annotations

from typing import Iterable, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.dtypes import DtypePolicy
from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.layers.base import LayerImpl, register_layer_impl
from deeplearning4j_tpu_torch.ops.initializers import init_weights


def _lstm_shapes(n_in: int, n: int, peepholes: bool):
    shapes = {"W": (n_in, 4 * n), "RW": (n, 4 * n), "b": (4 * n,)}
    if peepholes:
        shapes.update(pI=(n,), pF=(n,), pO=(n,))
    return shapes


def _lstm_params(gen, n_in: int, n: int, conf, peepholes: bool, dtype):
    """The reference's ``_lstm_params``: both matrices drawn with
    ``fan_out=n`` (not ``4n``), zero biases but the forget gate's
    ``forget_gate_bias_init``, zero peepholes."""
    W = init_weights(gen, (n_in, 4 * n), conf.weight_init.value,
                     fan_in=n_in, fan_out=n, distribution=conf.dist,
                     dtype=dtype)
    RW = init_weights(gen, (n, 4 * n), conf.weight_init.value,
                      fan_in=n, fan_out=n, distribution=conf.dist,
                      dtype=dtype)
    b = torch.zeros((4 * n,), dtype=dtype)
    b[n:2 * n] = conf.forget_gate_bias_init
    params = {"W": W, "RW": RW, "b": b}
    if peepholes:
        for name in ("pI", "pF", "pO"):
            params[name] = torch.zeros((n,), dtype=dtype)
    return params


def _input_projection(pol: DtypePolicy, x, W, b):
    """All timesteps' input GEMM at once: ``[b, t, n_in] → [b, t, k]``."""
    bsz, t, _ = x.shape
    xW = pol.cast_compute(x).reshape(bsz * t, -1) @ pol.cast_compute(W)
    return pol.cast_output(xW).reshape(bsz, t, -1) + b


def _per_step(xW, mask):
    """``xW [b, t, k]`` and the ``[b, t]`` mask as per-timestep views. One
    ``unbind`` (its backward is one ``stack``) rather than ``xW[:, s]`` at
    each step, whose backward writes each step's gradient into a zeroed
    ``[b, t, k]`` and sums ``t`` of them."""
    ms = None if mask is None else mask.to(xW.dtype)[..., None].unbind(1)
    return xW.unbind(1), ms


def _lstm_scan(pol: DtypePolicy, params, x, act, *, peepholes: bool,
               mask=None, h0=None, c0=None, reverse: bool = False):
    """Run the LSTM over ``x [b, t, n_in]``; returns ``([b, t, n], (h_T,
    c_T))``. With ``reverse`` the loop runs ``t-1 … 0`` and writes each
    output at its own index."""
    bsz, t, _ = x.shape
    n = params["RW"].shape[0]
    xW = _input_projection(pol, x, params["W"], params["b"])
    zs, ms = _per_step(xW, mask)
    h = xW.new_zeros((bsz, n)) if h0 is None else h0
    c = xW.new_zeros((bsz, n)) if c0 is None else c0
    RW = pol.cast_compute(params["RW"])
    if peepholes:
        pI, pF, pO = params["pI"], params["pF"], params["pO"]
    ys = [None] * t
    for s in (range(t - 1, -1, -1) if reverse else range(t)):
        z = zs[s] + pol.cast_output(pol.cast_compute(h) @ RW)
        zi, zf, zo, zg = z.chunk(4, dim=-1)
        if peepholes:
            zi = zi + pI * c
            zf = zf + pF * c
        i = torch.sigmoid(zi)
        f = torch.sigmoid(zf)
        c_new = f * c + i * act(zg)
        if peepholes:
            zo = zo + pO * c_new
        h_new = torch.sigmoid(zo) * act(c_new)
        if ms is None:
            h, c = h_new, c_new
            ys[s] = h_new
        else:  # hold the carry at masked steps; zero the emitted output
            m = ms[s]
            h = m * h_new + (1.0 - m) * h
            c = m * c_new + (1.0 - m) * c
            ys[s] = h * m
    return torch.stack(ys, dim=1), (h, c)


@register_layer_impl(L.GravesLSTM)
class GravesLSTMImpl(LayerImpl):
    peepholes = True

    def param_shapes(self):
        return _lstm_shapes(self.conf.n_in, self.conf.n_out, self.peepholes)

    def init_params(self, gen):
        c = self.conf
        return _lstm_params(gen, c.n_in, c.n_out, c, self.peepholes,
                            self.policy.param_dtype)

    def forward(self, params, x, state, *, train=False, rng=None, mask=None):
        x = self.maybe_dropout(x, train=train, rng=rng)
        ys, (hT, cT) = _lstm_scan(self.policy, params, x,
                                  self.activation_fn(),
                                  peepholes=self.peepholes, mask=mask,
                                  h0=state.get("h"), c0=state.get("c"))
        new_state = dict(state)
        if "h" in state:  # stateful mode: thread the carry
            new_state["h"] = hT
            new_state["c"] = cT
        return ys, new_state


@register_layer_impl(L.LSTM)
class LSTMImpl(GravesLSTMImpl):
    peepholes = False


@register_layer_impl(L.GravesBidirectionalLSTM)
class BiLSTMImpl(LayerImpl):
    """Forward and backward Graves LSTM, outputs summed (the reference's
    ADD mode). It carries no rnn state: each call starts from zeros."""

    def param_shapes(self):
        one = _lstm_shapes(self.conf.n_in, self.conf.n_out, True)
        return {f"{d}.{k}": s for d in ("fwd", "bwd") for k, s in one.items()}

    def init_params(self, gen):
        c, dt = self.conf, self.policy.param_dtype
        return {d: _lstm_params(gen, c.n_in, c.n_out, c, True, dt)
                for d in ("fwd", "bwd")}

    def forward(self, params, x, state, *, train=False, rng=None, mask=None):
        x = self.maybe_dropout(x, train=train, rng=rng)
        act = self.activation_fn()
        yf, _ = _lstm_scan(self.policy, params["fwd"], x, act,
                           peepholes=True, mask=mask)
        yb, _ = _lstm_scan(self.policy, params["bwd"], x, act,
                           peepholes=True, mask=mask, reverse=True)
        return yf + yb, state


@register_layer_impl(L.GRU)
class GRUImpl(LayerImpl):
    """Gates ``[r, u, c]``, no recurrent bias. The reset gate applies
    before the recurrent product, ``cand = act(zc + (r·h) @ Rc)``, as in
    the reference (``torch.nn.GRU`` applies it after)."""

    def param_shapes(self):
        n_in, n = self.conf.n_in, self.conf.n_out
        return {"W": (n_in, 3 * n), "RW": (n, 3 * n), "b": (3 * n,)}

    def init_params(self, gen):
        c, dt = self.conf, self.policy.param_dtype
        n_in, n = c.n_in, c.n_out
        W = init_weights(gen, (n_in, 3 * n), c.weight_init.value,
                         fan_in=n_in, fan_out=n, distribution=c.dist,
                         dtype=dt)
        RW = init_weights(gen, (n, 3 * n), c.weight_init.value,
                          fan_in=n, fan_out=n, distribution=c.dist, dtype=dt)
        return {"W": W, "RW": RW, "b": torch.zeros((3 * n,), dtype=dt)}

    def forward(self, params, x, state, *, train=False, rng=None, mask=None):
        x = self.maybe_dropout(x, train=train, rng=rng)
        pol, act = self.policy, self.activation_fn()
        bsz, t, _ = x.shape
        n = self.conf.n_out
        xW = _input_projection(pol, x, params["W"], params["b"])
        zs, ms = _per_step(xW, mask)
        RW = pol.cast_compute(params["RW"])
        Rr, Ru, Rc = RW[:, :n], RW[:, n:2 * n], RW[:, 2 * n:]
        h = state.get("h")
        if h is None:
            h = xW.new_zeros((bsz, n))
        ys = []
        for s in range(t):
            zr, zu, zc = zs[s].chunk(3, dim=-1)
            hc = pol.cast_compute(h)
            r = torch.sigmoid(zr + pol.cast_output(hc @ Rr))
            u = torch.sigmoid(zu + pol.cast_output(hc @ Ru))
            cand = act(zc + pol.cast_output(pol.cast_compute(r * h) @ Rc))
            h_new = u * h + (1.0 - u) * cand
            if ms is None:
                h = h_new
                ys.append(h_new)
            else:
                m = ms[s]
                h = m * h_new + (1.0 - m) * h
                ys.append(h * m)
        new_state = dict(state)
        if "h" in state:
            new_state["h"] = h
        return torch.stack(ys, dim=1), new_state


@register_layer_impl(L.ImageLSTM)
class ImageLSTMImpl(LayerImpl):
    """Image-captioning LSTM (ImageLSTM.java). Params are the reference's:
    ``RW [n_in + hid, 4·hid]`` (input and recurrent gate weights in one
    matrix), ``gb [4·hid]`` the gate bias, ``W [hid, n_out]`` and ``b
    [n_out]`` the output projection. Decoding is :meth:`beam_search`."""

    def _hidden(self) -> int:
        return self.conf.hidden_size or self.conf.n_out

    def param_shapes(self):
        c, hid = self.conf, self._hidden()
        return {"RW": (c.n_in + hid, 4 * hid), "gb": (4 * hid,),
                "W": (hid, c.n_out), "b": (c.n_out,)}

    def init_params(self, gen):
        c, dt = self.conf, self.policy.param_dtype
        n_in, hid, n_out = c.n_in, self._hidden(), c.n_out
        RW = init_weights(gen, (n_in + hid, 4 * hid), c.weight_init.value,
                          fan_in=n_in + hid, fan_out=hid,
                          distribution=c.dist, dtype=dt)
        W = init_weights(gen, (hid, n_out), c.weight_init.value,
                         distribution=c.dist, dtype=dt)
        gb = torch.zeros((4 * hid,), dtype=dt)
        gb[hid:2 * hid] = c.forget_gate_bias_init
        return {"RW": RW, "gb": gb, "W": W,
                "b": torch.zeros((n_out,), dtype=dt)}

    def _cell(self, params, x_t, h, c):
        """One gate step (decoding): ``x_t [b, n_in]``, ``h``/``c [b, hid]``
        → ``(h', c')``."""
        hid, act = self._hidden(), self.activation_fn()
        z = torch.cat([x_t, h], dim=-1) @ params["RW"] + params["gb"]
        i = torch.sigmoid(z[:, :hid])
        f = torch.sigmoid(z[:, hid:2 * hid])
        o = torch.sigmoid(z[:, 2 * hid:3 * hid])
        c_new = f * c + i * act(z[:, 3 * hid:])
        return o * act(c_new), c_new

    def forward(self, params, x, state, *, train=False, rng=None, mask=None):
        x = self.maybe_dropout(x, train=train, rng=rng)
        n_in = self.conf.n_in
        # the combined RW splits into _lstm_scan's input and recurrent halves
        view = {"W": params["RW"][:n_in], "RW": params["RW"][n_in:],
                "b": params["gb"]}
        hs, (hT, cT) = _lstm_scan(self.policy, view, x, self.activation_fn(),
                                  peepholes=False, mask=mask,
                                  h0=state.get("h"), c0=state.get("c"))
        # f32 hidden states meet a bf16 copy under master weights: the
        # product is taken in f32, as the reference's promotion does
        ys = hs @ params["W"].to(hs.dtype) + params["b"]
        if mask is not None:  # zero padded steps after the bias add
            ys = ys * mask.to(ys.dtype)[..., None]
        new_state = dict(state)
        if "h" in state:
            new_state["h"] = hT
            new_state["c"] = cT
        return ys, new_state

    def beam_search(self, params, xi, word_vectors, n_steps: int = 20,
                    beam_width: int = 3, end_token: Optional[int] = None):
        """Decode token sequences conditioned on the image embedding ``xi
        [n_in]`` (consumed as step 0); ``word_vectors [n_out, n_in]`` is
        each token's input vector. Returns ``[(tokens, log_prob)]``
        best-first. The host drives an eager single-step cell and ranks
        each beam's candidates with ``np.argsort`` on host copies, as the
        reference does."""
        dev, dt = params["RW"].device, params["RW"].dtype
        hid = self._hidden()
        ws = torch.as_tensor(np.asarray(word_vectors)).to(dev, dt)
        with torch.no_grad():
            zeros = torch.zeros((1, hid), dtype=dt, device=dev)
            xi_t = torch.as_tensor(np.asarray(xi)).to(dev, dt)[None, :]
            h, c = self._cell(params, xi_t, zeros, zeros)
            beams = [(0.0, [], h, c)]
            done = []
            for _ in range(n_steps):
                candidates = []
                for logp, toks, h, c in beams:
                    logprobs = torch.log_softmax(
                        h @ params["W"] + params["b"], dim=-1)[0].cpu().numpy()
                    for tok in np.argsort(-logprobs)[:beam_width]:
                        candidates.append((logp + float(logprobs[tok]),
                                           toks + [int(tok)], h, c))
                candidates.sort(key=lambda cand: -cand[0])
                beams = []
                for logp, toks, h, c in candidates[:beam_width]:
                    if end_token is not None and toks[-1] == end_token:
                        done.append((toks, logp))
                        continue
                    h2, c2 = self._cell(params, ws[toks[-1]][None, :], h, c)
                    beams.append((logp, toks, h2, c2))
                if not beams:
                    break
        done.extend((toks, logp) for logp, toks, _, _ in beams)
        return sorted(done, key=lambda p: -p[1])


def zero_rnn_state(layer_confs: Iterable[Tuple[str, L.LayerConf]], batch: int,
                   device, dtype=torch.float32):
    """Zero ``h`` (and ``c``) carries for the stateful layers among
    ``(key, conf)`` pairs, keyed as given; ``None`` when there is none.
    The bidirectional LSTM carries no state (as in the reference)."""
    state = {}
    for key, lc in layer_confs:
        if isinstance(lc, L.ImageLSTM):
            n, names = lc.hidden_size or lc.n_out, ("h", "c")
        elif isinstance(lc, (L.GravesLSTM, L.LSTM)):
            n, names = lc.n_out, ("h", "c")
        elif isinstance(lc, L.GRU):
            n, names = lc.n_out, ("h",)
        else:
            continue
        state[key] = {k: torch.zeros((batch, n), dtype=dtype, device=device)
                      for k in names}
    return state or None
