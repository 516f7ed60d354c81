"""Variational autoencoder layer — port of
``deeplearning4j_tpu/nn/layers/variational.py``
(``VariationalAutoencoder`` with Gaussian or Bernoulli reconstruction).

Inside a net the layer outputs the mean of q(z|x); pretraining minimises
the negative ELBO (:meth:`VariationalAutoencoder.elbo_loss`), the
reparameterisation's noise drawn from a ``torch.Generator`` (or given,
``eps``). Params hold the encoder and decoder stacks as lists of
``{"W", "b"}``, like the reference's trees.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Sequence

import torch

from .. import activations as _act
from .base import Ctx, Layer


@dataclass
class VariationalAutoencoder(Layer):
    """VAE as a (pretrainable) layer: nIn → encoder → z (nOut) → decoder
    → nIn."""

    n_in: int = None
    n_out: int = 32                                   # latent size
    encoder_layer_sizes: Sequence[int] = (256,)
    decoder_layer_sizes: Sequence[int] = (256,)
    activation: Any = "leakyrelu"
    pzx_activation: Any = "identity"                  # q(z|x) mean head
    reconstruction_distribution: str = "gaussian"     # or "bernoulli"
    num_samples: int = 1

    def _mlp_init(self, gen, sizes, n_in):
        params = []
        for n in sizes:
            params.append({"W": self._make_weight(gen, (n_in, n)),
                           "b": self._make_bias((n,))})
            n_in = n
        return params, n_in

    def init(self, gen, input_shape):
        n_in = self.n_in or input_shape[-1]
        self.n_in = n_in
        enc, h = self._mlp_init(gen, self.encoder_layer_sizes, n_in)
        mean_head = {"W": self._make_weight(gen, (h, self.n_out)),
                     "b": self._make_bias((self.n_out,))}
        logvar_head = {"W": self._make_weight(gen, (h, self.n_out)),
                       "b": self._make_bias((self.n_out,))}
        dec, h2 = self._mlp_init(gen, self.decoder_layer_sizes, self.n_out)
        out_dim = n_in * (2 if self.reconstruction_distribution ==
                          "gaussian" else 1)
        recon_head = {"W": self._make_weight(gen, (h2, out_dim)),
                      "b": self._make_bias((out_dim,))}
        return ({"encoder": enc, "mean": mean_head, "logvar": logvar_head,
                 "decoder": dec, "recon": recon_head}, {}, (self.n_out,))

    # ---- pieces ------------------------------------------------------------
    def _mlp(self, layers, x):
        f = _act.get(self.activation)
        for p in layers:
            x = f(x @ p["W"].to(x.dtype) + p["b"].to(x.dtype))
        return x

    def encode(self, params, x):
        h = self._mlp(params["encoder"], x)
        mean = _act.get(self.pzx_activation)(
            h @ params["mean"]["W"] + params["mean"]["b"])
        logvar = h @ params["logvar"]["W"] + params["logvar"]["b"]
        return mean, logvar

    def decode(self, params, z):
        h = self._mlp(params["decoder"], z)
        return h @ params["recon"]["W"] + params["recon"]["b"]

    def apply(self, params, state, x, ctx: Ctx):
        mean, _ = self.encode(params, self._cast_in(x))
        return mean, state

    # ---- ELBO (pretrain objective) ----------------------------------------
    def _recon_log_prob(self, recon_raw, x):
        if self.reconstruction_distribution == "bernoulli":
            logits = recon_raw
            return -torch.sum(torch.clamp(logits, min=0) - logits * x
                              + torch.log1p(torch.exp(-torch.abs(logits))),
                              dim=-1)
        mu, logvar = torch.chunk(recon_raw, 2, dim=-1)
        return -0.5 * torch.sum(logvar + (x - mu) ** 2 / torch.exp(logvar)
                                + math.log(2 * math.pi), dim=-1)

    def _noise(self, shape, like, gen, eps, i):
        if eps is not None:
            return eps[i]
        return torch.randn(shape, generator=gen, dtype=like.dtype,
                           device=like.device)

    def elbo_loss(self, params, x, gen=None, eps=None):
        """Negative ELBO (to minimise): reconstruction NLL + KL(q(z|x) ‖
        N(0, 1)). ``eps`` (num_samples, B, nOut) gives the noise, else it
        is drawn from ``gen``."""
        x = x.reshape(x.shape[0], -1)
        mean, logvar = self.encode(params, x)
        kl = 0.5 * torch.sum(torch.exp(logvar) + mean ** 2 - 1.0 - logvar,
                             dim=-1)
        nll = 0.0
        for i in range(self.num_samples):
            z = mean + torch.exp(0.5 * logvar) * self._noise(
                mean.shape, mean, gen, eps, i)
            nll = nll - self._recon_log_prob(self.decode(params, z), x)
        return torch.mean(nll / self.num_samples + kl)

    # ---- reference API: reconstruction / generation ------------------------
    def _mean_of(self, raw):
        if self.reconstruction_distribution == "bernoulli":
            return torch.sigmoid(raw)
        return torch.chunk(raw, 2, dim=-1)[0]

    def reconstruct(self, params, x, gen=None, eps=None):
        mean, logvar = self.encode(params, x.reshape(x.shape[0], -1))
        z = mean
        if gen is not None or eps is not None:
            noise = eps if eps is not None else torch.randn(
                mean.shape, generator=gen, dtype=mean.dtype,
                device=mean.device)
            z = mean + torch.exp(0.5 * logvar) * noise
        return self._mean_of(self.decode(params, z))

    def generate_given_z(self, params, z):
        return self._mean_of(self.decode(params, z))

    def reconstruction_probability(self, params, x, gen=None,
                                   num_samples=5, eps=None):
        """Mean log p(x|z) over samples of q(z|x)
        (reconstructionLogProbability)."""
        x = x.reshape(x.shape[0], -1)
        mean, logvar = self.encode(params, x)
        total = 0.0
        for i in range(num_samples):
            z = mean + torch.exp(0.5 * logvar) * self._noise(
                mean.shape, mean, gen, eps, i)
            total = total + self._recon_log_prob(self.decode(params, z), x)
        return total / num_samples

    def pretrain_fit(self, params, x_batches, updater=None, gen=None,
                     epochs: int = 1):
        """Layerwise pretraining (reference MultiLayerNetwork.pretrain):
        the updater steps the params in place; returns (params, last
        loss)."""
        from ...train.updaters import Adam, apply_updates, tree_leaves
        from ..multi_layer_network import _unflatten
        opt = (updater or Adam(1e-3)).to_transform()
        with torch.no_grad():
            opt_state = opt.init(params)
        leaves = tree_leaves(params)
        loss = None
        for _ in range(epochs):
            for x in x_batches:
                x = torch.as_tensor(x, device=leaves[0].device)
                loss = self.elbo_loss(params, x, gen)
                grads = _unflatten(params, iter(
                    torch.autograd.grad(loss, leaves)))
                with torch.no_grad():
                    updates, opt_state = opt.update(grads, opt_state, params)
                    apply_updates(leaves, tree_leaves(updates))
        return params, loss
