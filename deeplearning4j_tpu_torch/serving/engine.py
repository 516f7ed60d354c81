"""Generation engine for the Transformer-LM: KV-cache prefill, chunked
prefill and single-token decode, plus greedy/temperature/top-k sampling.
Port of ``deeplearning4j_tpu/serving/engine.py``.

- ``prefill`` / ``prefill_slot`` run the prompt through the model's own
  block stack (``apply_blocks(return_kv=True)`` — so a prompt padded to a
  bucket of ≥ ``flash_min_seq`` tokens runs the flash kernel on CUDA),
  write every layer's k/v into the cache and return only the last valid
  position's logits.
- ``decode_step`` advances every slot one token: embed at each slot's
  cursor, run the blocks with the cache, attend against the slot's own
  prefix — dense lanes, or the block-paged pool through either the gather
  path or the CUDA paged-attention kernel (``kernels.paged_attention``).
- ``prefill_chunk`` writes one chunk of a slot's context into its mapped
  pages (paged pools); ``verify_chunk`` runs the same body and returns
  every row's logits (SCORE requests), ``embed_chunk`` returns its
  post-``ln_f`` hidden rows instead (EMBED requests).
- ``sample_masked`` floors the logits a (B, V) bool mask refuses before
  the sampler (CONSTRAINED requests).

**The cache is updated in place.** The reference donates the cache to
each jitted call so XLA reuses its buffers; PyTorch has no donation, so
the engine writes the KV pool (and cursors) in place and returns the same
tensors. Callers keep the ``(logits, cache)`` calling convention of the
reference, but the cache they passed in IS the one returned.

**Compiled entry points.** Each entry point is a step body that reads
only tensors — the slot, start and length of a call reach it as device
tensors, staged from the host through pinned memory — run by a
:class:`~deeplearning4j_tpu_torch.nn._compiled.CompiledStep` inside a
:class:`~deeplearning4j_tpu_torch.obs.compiles.CompileSentinel` named as
the reference names its jitted functions (``decode_step``,
``decode_paged``, ``decode_paged_kernel``, ``prefill``,
``prefill_slot``, ``prefill_chunk``, ``verify_chunk``, ``embed_chunk``,
``sample_tokens``, ``sample_tokens_masked``, ``copy_page``).
On CUDA each signature's first call is eager, its second is captured as
a CUDA graph, and later calls copy their inputs in and replay it; on the
CPU and under ``disable_graphs()`` the same bodies run directly. One
signature is one prefill or chunk bucket (the slot, start and length are
data, not part of it), so compiles stay at one per bucket as in the
reference.

Where the port differs from the reference: a graph bakes the addresses
of the cache it was captured on, so a signature is the reference's
abstract signature **plus the identity of the cache** (on the CPU too, so
that ``compile_report()`` means the same everywhere): a second cache of
the same shapes starts its own signatures, and a cache's graphs go when
the cache is freed. ``generate()`` allocates a cache per call, and so
compiles per call. The weights are the engine's own copies:
``refresh(params)`` at unchanged shapes copies the new values into them
in place (no graph is dropped, nothing recompiles); a change of shape
drops the graphs.

Out-of-bounds writes are masked explicitly where a JAX scatter would drop
them (a paged write on the sentinel page, a dense write past capacity),
and gathers through the sentinel clamp to the last page as a JAX gather
does; dynamic-slice starts are bounds-checked on the host instead of
clamped.

The sentinels feed the observability plane: every compile counts into
``dl4j_compile_total{component}`` and ``dl4j_compile_seconds``, a retrace
after ``mark_warm()`` into ``dl4j_compile_retraces_total``, and each lands
as a ``compile.<name>`` span on the process tracer.

**The quantization plane** (``serving/quant.py``). ``quant_kv`` and
``quant_weights`` pin the modes (off|on|auto|race; None defers to
``$DL4J_QUANT_KV`` / ``$DL4J_QUANT_W``, default auto = bf16).
``init_paged_cache(quantized=None)`` asks ``quant.decide_kv``; an int8 pool
quantizes rows where they are written and dequantizes them where the
decode and chunk bodies gather them, in plain torch (the reference does it
in XLA, outside its kernel). K2 reads compute-dtype pages only: it refuses
an int8 pool, and ``decode_step`` sends such a pool to the gather-dequant
body, a storage mode the caller chose. The decode-side entry points
(``decode_step``, ``decode_paged``, ``decode_paged_kernel``,
``verify_chunk``) take the weight set as a static argument — ``"bf16"``
(the engine's weights) or ``"int8"`` (the block stack of
``quant.quantize_block_weights``, dequantized a layer at a time by
:func:`_wload`) — resolved once by ``quant.decide_weights``
(:meth:`GenerationEngine._decode_params`); so a graph captured with one
set never replays with the other. Prefills always run the engine's own
weights, as in the reference.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from .._device import resolve_device, tree_to
from ..kernels import paged_attention as pa
from ..nn._compiled import Bound, CompiledStep, copy_into, tensors
from ..obs.compiles import CompileSentinel
from ..zoo import transformer as tfm
from . import kvcache, quant

DEFAULT_PREFILL_BUCKETS = (32, 128, 512, 1024, 2048, 4096, 8192)

_NEG_INF = -1e30  # mask value: finite, softmax-safe in f32

# weights that only ever feed a matmul in the compute dtype — the engine
# casts them once instead of on every call
_MATMUL_WEIGHTS = ("wqkv", "wo", "w_in", "w_out")


def sample_tokens(logits, temperature, top_k, generator=None):
    """Vectorized next-token sampling: (B, V) logits, per-slot
    ``temperature`` (B,) and ``top_k`` (B,). A slot with
    ``temperature <= 0`` is greedy (argmax, first index on ties); one with
    ``top_k > 0`` samples only among its k highest logits. Randomness
    comes from ``generator`` (Gumbel-max over the filtered, tempered
    logits — the same distribution as ``jax.random.categorical``, not the
    same draws). Returns (B,) int32 on the logits' device."""
    if not torch.is_tensor(temperature) and \
            not (np.asarray(temperature) > 0).any():
        return _sample_greedy(logits)
    dev = logits.device
    temperature = torch.as_tensor(temperature, dtype=torch.float32,
                                  device=dev).reshape(-1)
    top_k = torch.as_tensor(top_k, dtype=torch.int64, device=dev).reshape(-1)
    return _sample_tempered(logits, temperature, top_k, generator)


def _sample_greedy(logits):
    return logits.float().argmax(dim=-1).to(torch.int32)


def _sample_tempered(logits, temperature, top_k, generator):
    """:func:`sample_tokens` on device tensors only (a captured step)."""
    logits = logits.float()
    b, v = logits.shape
    greedy = logits.argmax(dim=-1)
    desc = torch.sort(logits, dim=-1, descending=True).values
    kk = torch.clamp(torch.where(top_k > 0, top_k, torch.full_like(top_k, v)),
                     1, v)
    thresh = desc.gather(-1, (kk - 1)[:, None])
    filtered = logits.masked_fill(~(logits >= thresh), _NEG_INF)
    scaled = filtered / torch.clamp(temperature, min=1e-6)[:, None]
    u = torch.rand((b, v), generator=generator, device=logits.device)
    gumbel = -torch.log(-torch.log(u.clamp(min=1e-20)))
    sampled = (scaled + gumbel).argmax(dim=-1)
    return torch.where(temperature <= 0, greedy, sampled).to(torch.int32)


def _sample_masked_step(logits, temperature, top_k, generator, mask):
    """The ``sample_tokens_masked`` entry point's body: ``mask`` (B, V)
    bool — a refused token's logit drops to the mask floor BEFORE the
    top-k threshold and the greedy argmax, so every token drawn lies
    inside the mask. One signature a batch size, greedy and tempered rows
    alike (a greedy row takes the argmax, as ``_sample_greedy`` does, so
    an all-true mask gives the plain sampler's greedy tokens bit for
    bit)."""
    return _sample_tempered(logits.float().masked_fill(~mask, _NEG_INF),
                            temperature, top_k, generator)


def _sample_step(logits, temperature, top_k, generator):
    """The ``sample_tokens`` entry point's body: greedy when no
    temperature is given (its own signature), else tempered."""
    if temperature is None:
        return _sample_greedy(logits)
    return _sample_tempered(logits, temperature, top_k, generator)


def _copy_page_step(cache, pages):
    """The ``copy_page`` entry point's body: pool page ``pages[0]``'s k/v
    rows (every layer; an int8 pool's scales with them) into page
    ``pages[1]``."""
    src, dst = pages[0:1], pages[1:2]
    for name in ("k", "v", "k_scale", "v_scale"):
        if name in cache:
            cache[name].index_copy_(1, dst,
                                    cache[name].index_select(1, src))


def _wload(blocks, name, layer, dt):
    """Layer ``layer``'s weight ``name`` in compute dtype ``dt``: an int8
    block stack (``quant.quantize_block_weights``) carries one scale an
    output channel under ``name + "_scale"`` and is dequantized here, so
    storage is int8 and the matmul runs in ``dt``."""
    w = blocks[name][layer]
    s = blocks.get(name + "_scale")
    if s is None:
        return w
    return (w.float() * s[layer].float()).to(dt)


def _cached_attention(cfg, q, k, v, pos):
    """Single-token attention against the cache: q (B, H, Dh) vs k/v
    (B, S, H, Dh), each slot masked to rows ``<= pos[b]``. Scores in f32
    whatever the cache dtype."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bhd,bshd->bhs", q.float() * scale, k.float())
    s = k.shape[1]
    mask = torch.arange(s, device=q.device)[None, :] <= pos.long()[:, None]
    scores = scores.masked_fill(~mask[:, None, :], _NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhs,bshd->bhd", probs, v.float())
    return out.to(cfg.dtype)


def _masked_row_write(pool, idx, ok, rows):
    """Scatter ``rows`` (N, ...) into ``pool`` (R, ...) at flat rows
    ``idx`` (N,), in range, where ``ok`` (N,) — the rows a JAX scatter
    would drop (``ok`` False) write nothing. Done without a host sync:
    a dropped row is redirected to the first live row's target carrying
    that row's data (or, with no live row at all, to its own target
    carrying the current contents), so every duplicate index of the one
    ``index_put_`` writes identical values and the result is exact and
    deterministic. Live targets must be distinct (one writer per row).
    (``index_select`` with a one-element index, not ``x[first]``: a 0-d
    tensor index would copy it to the host and stall the stream.)"""
    rows = rows.to(pool.dtype)
    first = torch.argmax(ok.to(torch.int32)).reshape(1)
    idx_first = idx.index_select(0, first)
    tgt = torch.where(ok, idx, idx_first)
    filler = torch.where(ok.any(), rows.index_select(0, first),
                         pool.index_select(0, idx_first))
    src = torch.where(ok.view(-1, *[1] * (rows.dim() - 1)), rows, filler)
    pool.index_put_((tgt,), src)




def _owned(tree, device):
    """A copy of every tensor leaf on ``device`` (never the caller's)."""
    if isinstance(tree, dict):
        return {k: _owned(v, device) for k, v in tree.items()}
    return tree.to(device=device, copy=True)


def _layout(tree):
    """Nested keys with each leaf's shape and dtype."""
    if isinstance(tree, dict):
        return {k: _layout(v) for k, v in tree.items()}
    return (tuple(tree.shape), tree.dtype)


class GenerationEngine:
    """Prefill/decode engine bound to one (cfg, params) pair, on one
    device. Callers own the cache (``init_cache`` / ``init_paged_cache``)
    and thread it through the entry points, which update it in place.

    ``device=None`` means the CUDA card (raises without one); tests pass
    ``device="cpu"``, where the kernels' plain versions run. ``sentinels``
    maps each compiled entry point's name to its
    :class:`~deeplearning4j_tpu_torch.obs.compiles.CompileSentinel`."""

    def __init__(self, cfg, params, *, max_len: Optional[int] = None,
                 prefill_buckets=DEFAULT_PREFILL_BUCKETS,
                 prefill_chunk: Optional[int] = None,
                 paged_kernel: Optional[str] = None,
                 quant_kv: Optional[str] = None,
                 quant_weights: Optional[str] = None,
                 device=None):
        if getattr(cfg, "n_experts", 0):
            raise NotImplementedError(
                "GenerationEngine is dense-only: MoE blocks are not ported")
        if cfg.use_ring_attention:
            raise NotImplementedError(
                "ring attention is a sequence-parallel training path; "
                "construct the engine with use_ring_attention=False")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.max_len = int(cfg.max_seq if max_len is None else max_len)
        if self.max_len > cfg.max_seq:
            raise ValueError(
                f"max_len {self.max_len} exceeds cfg.max_seq="
                f"{cfg.max_seq}: no position rows past the table")
        self.prefill_buckets = tuple(sorted(
            {min(b, self.max_len) for b in prefill_buckets} | {self.max_len}))
        self.chunk_len = int(min(
            kvcache.DEFAULT_PREFILL_CHUNK if prefill_chunk is None
            else prefill_chunk, self.max_len))
        if self.chunk_len < 1:
            raise ValueError("prefill_chunk must be >= 1")
        self.chunk_buckets = tuple(sorted(
            {min(b, self.chunk_len) for b in self.prefill_buckets}
            | {self.chunk_len}))
        # off|on|auto (None: auto — the kernel on CUDA, gather on the
        # CPU); kernels.paged_attention.decide reads it, once per cache
        # geometry (_paged_kernel_choice)
        self.paged_kernel_mode = paged_kernel
        self._paged_plan = {}
        # the quantization plane's modes (off|on|auto|race; None defers
        # to $DL4J_QUANT_KV / $DL4J_QUANT_W — serving.quant.decide_*); the
        # decode weight set is resolved lazily, once, and the int8 block
        # stack built only when it is chosen (or raced)
        self.quant_kv_mode = quant_kv
        self.quant_weights_mode = quant_weights
        self._wchoice: Optional[str] = None
        self._qrun = None
        self._default_gen = None
        self.params = None
        self.refresh(params)

        def weights():
            return tensors(self._run_params)

        def decode_weights():
            q = [] if self._qrun is None else tensors(self._qrun["blocks"])
            return tensors(self._run_params) + q

        def entry(name, body, bindings=weights):
            return CompileSentinel(name, CompiledStep(body, bindings, name))

        self._decode = entry("decode_step", self._decode_dense,
                             decode_weights)
        self._decode_paged = entry(
            "decode_paged",
            lambda cache, tokens, wmode: self._decode_paged_rows(
                cache, tokens, False, wmode), decode_weights)
        self._decode_paged_kernel = entry(
            "decode_paged_kernel",
            lambda cache, tokens, wmode: self._decode_paged_rows(
                cache, tokens, True, wmode), decode_weights)
        self._prefill = entry("prefill", self._prefill_pool)
        self._prefill_slot = entry("prefill_slot", self._prefill_slot_rows)
        self._prefill_chunk = entry("prefill_chunk",
                                    self._prefill_chunk_rows)
        # the same chunk body with every row's logits (SCORE) or the
        # post-ln_f hidden rows (EMBED) in place of the last row's logits
        self._verify_chunk = entry(
            "verify_chunk",
            lambda cache, tokens, meta, wmode: self._prefill_chunk_rows(
                cache, tokens, meta, out="logits", wmode=wmode),
            decode_weights)
        self._embed_chunk = entry(
            "embed_chunk",
            lambda cache, tokens, meta: self._prefill_chunk_rows(
                cache, tokens, meta, out="hidden"))
        self._sample = entry("sample_tokens", _sample_step, tuple)
        self._sample_masked = entry("sample_tokens_masked",
                                    _sample_masked_step, tuple)
        self._copy_page = entry("copy_page", _copy_page_step, tuple)
        self.sentinels = {s.name: s for s in (
            self._decode, self._prefill, self._prefill_slot, self._sample,
            self._decode_paged, self._decode_paged_kernel,
            self._prefill_chunk, self._verify_chunk, self._copy_page,
            self._embed_chunk, self._sample_masked)}

    # ------------------------------------------------------------ cache
    def init_cache(self, n_slots: int):
        return kvcache.init_cache(self.cfg, n_slots, self.max_len,
                                  device=self.device)

    def init_paged_cache(self, n_slots: int, n_pages: int,
                         page_len: int = kvcache.DEFAULT_PAGE_LEN,
                         quantized: Optional[bool] = None):
        """Allocate the paged pool. ``quantized=None`` asks
        ``quant.decide_kv`` (the engine's ``quant_kv`` mode: bf16 unless
        pinned on or raced and promoted)."""
        if quantized is None:
            quantized = quant.decide_kv(self, n_slots, n_pages,
                                        page_len) == "int8"
        return kvcache.init_paged_cache(self.cfg, n_slots, n_pages,
                                        page_len, self.max_len,
                                        device=self.device,
                                        quantized=bool(quantized))

    def refresh(self, params):
        """Swap in new params. The engine keeps its own copies on its
        device (never the caller's tensors), with the matmul weights cast
        to the compute dtype once, here. At the shapes and dtypes it
        already holds, the new values are copied into the same tensors:
        the compiled steps keep their graphs (the reference's "no retrace
        as long as shapes match"). Any other change makes new tensors,
        and the compiled steps drop their graphs on their next call. An
        int8 block stack is derived state: re-quantized into its own
        tensors at the same shapes, dropped (and rebuilt when next
        needed) otherwise."""
        new = tree_to(params, self.device)
        if self.params is not None and _layout(new) == _layout(self.params):
            copy_into(self.params, new)
            run, own = self._run_params, self.params
            for name in _MATMUL_WEIGHTS:
                if run["blocks"][name] is not own["blocks"][name]:
                    run["blocks"][name].copy_(own["blocks"][name])
            if "head" in run and run["head"] is not own["head"]:
                run["head"].copy_(own["head"])
            if self._qrun is not None:
                fresh = quant.quantize_block_weights(own["blocks"])
                for name, t in self._qrun["blocks"].items():
                    if t is not fresh[name]:
                        t.copy_(fresh[name])
            return self
        self._qrun = None
        self.params = _owned(new, self.device)
        run = dict(self.params)
        blocks = dict(run["blocks"])
        for name in _MATMUL_WEIGHTS:
            blocks[name] = blocks[name].to(self.cfg.dtype)
        run["blocks"] = blocks
        if "head" in run:
            run["head"] = run["head"].to(self.cfg.dtype)
        self._run_params = run
        return self

    def _quantized_weights(self):
        """The int8 weight set: the run params with the block stack's
        matmul weights quantized (``quant.quantize_block_weights`` of the
        engine's own weights), built once."""
        if self._qrun is None:
            self._qrun = dict(self._run_params,
                              blocks=quant.quantize_block_weights(
                                  self.params["blocks"]))
        return self._qrun

    def _decode_params(self) -> str:
        """The weight set the decode-side entry points run: ``"int8"``
        when ``quant.decide_weights`` picks it, else ``"bf16"`` (the
        engine's weights). Resolved once an engine, lazily (a race needs
        the compiled decode)."""
        if self._wchoice is None:
            self._wchoice = quant.decide_weights(self)
        if self._wchoice == "int8":
            self._quantized_weights()
        return self._wchoice

    def _weights(self, wmode):
        """The params tree of weight set ``wmode`` ("bf16" | "int8")."""
        return self._qrun if wmode == "int8" else self._run_params

    # -------------------------------------------------- compile plane
    def mark_warm(self):
        """Declare warmup over on every sentinel: the signatures seen so
        far are the working set; any compile after this is a warned
        retrace."""
        for s in self.sentinels.values():
            s.mark_warm()
        return self

    def compile_report(self):
        """{entry point: {name, compiles, signatures, warm,
        retraces_after_warm}}."""
        return {name: s.report() for name, s in self.sentinels.items()}

    def release_bound(self, obj):
        """Drop every entry point's graphs bound to ``obj`` (a cache
        leaf or a generator that is going away for good)."""
        for s in self.sentinels.values():
            s.drop_bound(obj)

    # ----------------------------------------------------- step bodies
    def _prefill_trunk(self, tokens):
        """Shared prompt pass: embedded tokens through the block stack
        with per-layer k/v capture. Returns (hidden, k, v)."""
        p = self._run_params
        x = tfm.embed(p, self.cfg, tokens)
        x, _, (ks, vs) = tfm.apply_blocks(p["blocks"], self.cfg, x,
                                          return_kv=True)
        return x, ks, vs

    def _embed_rows(self, tokens, pos):
        """Embed one token row per sequence at its own position (clamped
        into the table, like the reference's take)."""
        cfg = self.cfg
        p = self._run_params
        x = tfm.scale_embedding(cfg, p["embed"][tokens.long()].to(cfg.dtype))
        rows = p["pos_embed"][pos.long().clamp(0, cfg.max_seq - 1)]
        return x + rows.to(cfg.dtype)

    def _blocks_with_cache(self, cache, x, *, write, attend,
                           wmode="bf16"):
        """The ONE block body every cached entry point runs — they differ
        only in how k/v rows land in the layer cache (``write(layer_pool,
        rows)``, in place) and how the rows' queries see it
        (``attend(q, kl, vl) -> (rows, H, Dh)``). An int8 pool hands each
        closure a layer's ``(rows, scales)`` pair instead of its rows:
        the closures own the quantize-at-append and dequantize-at-gather.
        ``wmode`` picks the weight set. Returns the block-stack output
        rows."""
        cfg = self.cfg
        blocks = self._weights(wmode)["blocks"]
        n = x.shape[0]
        h_, dh = cfg.n_heads, cfg.head_dim
        quantized = kvcache.is_quantized(cache)
        for l in range(cfg.n_layers):
            hh = tfm._rmsnorm(x, blocks["ln1"][l])
            qkv = hh @ _wload(blocks, "wqkv", l, hh.dtype)
            q, k, v = qkv.chunk(3, dim=-1)
            if quantized:
                kl = (cache["k"][l], cache["k_scale"][l])
                vl = (cache["v"][l], cache["v_scale"][l])
            else:
                kl, vl = cache["k"][l], cache["v"][l]
            write(kl, k.reshape(n, h_, dh))
            write(vl, v.reshape(n, h_, dh))
            a = attend(q.reshape(n, h_, dh), kl, vl).reshape(n, h_ * dh)
            x = x + a @ _wload(blocks, "wo", l, hh.dtype)
            h2 = tfm._rmsnorm(x, blocks["ln2"][l])
            x = x + tfm.gelu(h2 @ _wload(blocks, "w_in", l, h2.dtype)) \
                @ _wload(blocks, "w_out", l, h2.dtype)
        return x

    def _head(self, x):
        return tfm.head_logits_rows(self._run_params, self.cfg, x)

    def _decode_dense(self, cache, tokens, wmode):
        """One decode step over dense lanes: each slot writes its token's
        k/v at its own cursor and attends to its own prefix. A slot past
        capacity writes nothing (the reference's dropped scatter); its
        output is garbage the scheduler never reads. Returns (B, V)."""
        cfg = self.cfg
        pos = cache["pos"]
        b = tokens.shape[0]
        s = cache["k"].shape[2]
        x = self._embed_rows(tokens, pos)
        ok = (pos >= 0) & (pos < s)
        idx = torch.arange(b, device=pos.device) * s \
            + pos.long().clamp(0, s - 1)

        def write(kl, rows):
            _masked_row_write(kl.view(-1, *kl.shape[2:]), idx, ok, rows)

        x = self._blocks_with_cache(
            cache, x, write=write,
            attend=lambda q, kl, vl: _cached_attention(cfg, q, kl, vl, pos),
            wmode=wmode)
        logits = self._head(x)
        pos.add_(1)
        return logits

    def _paged_write(self, cache, ent, off):
        """The write closure of the paged paths: rows land at (pool page
        ``ent``, offset ``off``); an entry on the sentinel writes nothing.
        An int8 pool quantizes the rows here and writes their scales to
        the same (page, offset)."""
        npg, plen = cache["k"].shape[1], cache["k"].shape[2]
        ok = ent < npg
        idx = ent.long().clamp(0, npg - 1) * plen + off.long()

        def write_rows(kl, rows):
            _masked_row_write(kl.view(-1, *kl.shape[2:]), idx, ok, rows)

        if not kvcache.is_quantized(cache):
            return write_rows

        def write(kc, rows):
            qr, sc = quant.quantize_rows(rows)
            write_rows(kc[0], qr)
            write_rows(kc[1], sc)
        return write

    @staticmethod
    def _dequant_gather(kc, idx, rows, h_, dh):
        """An int8 layer pool's pages ``idx`` as f32 rows ``(-1, rows, H,
        Dh)`` (the sentinel clamped to the last page, as a JAX gather
        does): int8 × the per-row-per-head scale."""
        kl, ks = kc
        return kl[idx].reshape(-1, rows, h_, dh).float() \
            * ks[idx].reshape(-1, rows, h_)[..., None]

    def _decode_paged_rows(self, cache, tokens, use_kernel, wmode):
        """One decode step over the block-paged pool: each slot's k/v row
        scatters into (page, offset) through its table; attention either
        gathers the slot's table row, clamping the sentinel
        (``paged_attention_reference``; an int8 pool dequantizes what it
        gathers), or, with ``use_kernel``, runs the paged-attention
        wrapper on one layer's pool slice — same writes, block math and
        logits. K2 reads compute-dtype pages: it refuses an int8 pool.
        Returns (B, V)."""
        quantized = kvcache.is_quantized(cache)
        if use_kernel and quantized:
            raise NotImplementedError(
                "the paged-attention kernel reads compute-dtype pages; an "
                "int8 pool decodes through the gather-dequant path "
                "(decode_step routes it there)")
        cfg = self.cfg
        pos = cache["pos"]
        table = cache["pages"]
        b = tokens.shape[0]
        npg, plen = cache["k"].shape[1], cache["k"].shape[2]
        per_slot = table.shape[1]
        ar = torch.arange(b, device=pos.device)
        lp = pos.long() // plen
        ent = table[ar, lp.clamp(0, per_slot - 1)]
        ent = torch.where(lp < per_slot, ent, torch.full_like(ent, npg))
        write = self._paged_write(cache, ent, pos.long() % plen)
        x = self._embed_rows(tokens, pos)
        fn = pa.paged_attention if use_kernel else pa.paged_attention_reference
        if quantized:
            idx = table.long().clamp(0, npg - 1)
            s_len = per_slot * plen

        def attend(q, kl, vl):
            if quantized:
                kg = self._dequant_gather(kl, idx, s_len, cfg.n_heads,
                                          cfg.head_dim)
                vg = self._dequant_gather(vl, idx, s_len, cfg.n_heads,
                                          cfg.head_dim)
                return _cached_attention(cfg, q, kg, vg, pos)
            return fn(q.contiguous(), kl, vl, table, pos)

        x = self._blocks_with_cache(cache, x, write=write, attend=attend,
                                    wmode=wmode)
        logits = self._head(x)
        pos.add_(1)
        return logits

    def _prefill_chunk_rows(self, cache, tokens, meta, out="last",
                            wmode="bf16"):
        """One chunked-prefill dispatch: ``tokens`` (C_bucket,) — the
        slot's context rows ``[start, start+length)`` padded — written
        into the slot's mapped pages, the chunk's queries attending
        causally over everything the slot's table row names (pages a
        prefix shares with other slots are read like its own); ``meta``
        (3,) int64 is (slot, start, length). Rows past ``length`` are
        padding: their writes are masked. Returns the last valid row's
        logits (V,) (``out="last"``), every row's logits (C_bucket, V)
        (``"logits"``) or every row's post-``ln_f`` hidden state
        (C_bucket, d) f32 (``"hidden"``); rows past ``length`` are
        garbage the caller slices off."""
        cfg = self.cfg
        slot, start, length = meta[0:1], meta[1:2], meta[2:3]
        table = cache["pages"]
        npg, plen = cache["k"].shape[1], cache["k"].shape[2]
        per_slot = table.shape[1]
        h_, dh = cfg.n_heads, cfg.head_dim
        dev = tokens.device
        c = tokens.shape[0]
        ar = torch.arange(c, device=dev)
        gpos = start + ar
        valid = ar < length
        row = table.index_select(0, slot)[0]
        lp = gpos // plen
        ent = row[lp.clamp(0, per_slot - 1)]
        ent = torch.where(valid & (lp < per_slot), ent,
                          torch.full_like(ent, npg))
        write = self._paged_write(cache, ent, gpos % plen)
        x = self._embed_rows(tokens, gpos)
        s_len = per_slot * plen
        mask = torch.arange(s_len, device=dev)[None, :] <= gpos[:, None]
        gidx = row.long().clamp(0, npg - 1)
        scale = 1.0 / math.sqrt(dh)
        quantized = kvcache.is_quantized(cache)

        def attend(q, kl, vl):
            if quantized:
                kg = self._dequant_gather(kl, gidx, s_len, h_, dh)[0]
                vg = self._dequant_gather(vl, gidx, s_len, h_, dh)[0]
            else:
                kg = kl[gidx].reshape(s_len, h_, dh)
                vg = vl[gidx].reshape(s_len, h_, dh)
            scores = torch.einsum("qhd,shd->qhs", q.float() * scale,
                                  kg.float())
            scores = scores.masked_fill(~mask[:, None, :], _NEG_INF)
            probs = torch.softmax(scores, dim=-1)
            return torch.einsum("qhs,shd->qhd", probs,
                                vg.float()).to(cfg.dtype)

        x = self._blocks_with_cache(cache, x, write=write, attend=attend,
                                    wmode=wmode)
        cache["pos"].index_copy_(0, slot, (start + length).to(torch.int32))
        if out == "logits":
            return self._head(x)
        if out == "hidden":
            return tfm.hidden_rows(self._run_params, cfg, x)
        last = x.index_select(0, (length - 1).clamp(0, c - 1))
        return self._head(last)[0]

    def _prefill_pool(self, cache, tokens, lengths):
        """Whole-pool prefill: ``tokens`` (B, T), ``lengths`` (B,) int64.
        Returns the last valid position's logits (B, V)."""
        b, t = tokens.shape
        x, ks, vs = self._prefill_trunk(tokens)
        cache["k"][:, :, :t] = ks.to(cache["k"].dtype)
        cache["v"][:, :, :t] = vs.to(cache["v"].dtype)
        last = (lengths - 1).clamp(0, t - 1)
        x_last = x[torch.arange(b, device=x.device), last]
        cache["pos"].copy_(lengths.to(torch.int32))
        return self._head(x_last)

    def _prefill_slot_rows(self, cache, tokens, meta):
        """One prompt into one slot of a dense pool: ``tokens`` (1,
        bucket), ``meta`` (2,) int64 is (slot, length). Only that slot's
        first ``bucket`` rows and its cursor change. Returns the last
        valid row's logits (V,)."""
        slot, n = meta[0:1], meta[1:2]
        bucket = tokens.shape[1]
        x, ks, vs = self._prefill_trunk(tokens)
        for name, rows in (("k", ks), ("v", vs)):
            pool = cache[name]
            pool[:, :, :bucket].index_copy_(1, slot, rows.to(pool.dtype))
        cache["pos"].index_copy_(0, slot, n.to(torch.int32))
        last = x[0].index_select(0, (n - 1).clamp(0, bucket - 1))
        return self._head(last)[0]

    # ------------------------------------------------------- host API
    def _stage(self, *arrays, dtype=np.int64):
        """Host arrays → ``dtype`` tensors on the engine's device, in
        their shapes. On CUDA they travel as one pinned buffer and one
        copy that does not block the host (a pageable copy may not run
        while a graph is captured); on the CPU they are plain tensors."""
        arrs = [np.asarray(a, dtype) for a in arrays]
        flat = torch.from_numpy(np.concatenate([a.reshape(-1)
                                                for a in arrs]))
        if self.device.type == "cuda":
            flat = flat.pin_memory().to(self.device, non_blocking=True)
        out, i = [], 0
        for a in arrs:
            out.append(flat[i:i + a.size].view(a.shape))
            i += a.size
        return out

    def copy_page(self, cache, src: int, dst: int):
        """Copy pool page ``src``'s k/v rows (every layer) into page
        ``dst``, in place — the device half of a copy-on-write split."""
        if not kvcache.is_paged(cache):
            raise ValueError("copy_page needs a paged cache")
        npg = kvcache.n_pages(cache)
        if not (0 <= int(src) < npg and 0 <= int(dst) < npg):
            raise ValueError(f"page copy {src}->{dst} outside the "
                             f"{npg}-page pool")
        (pages,) = self._stage([int(src), int(dst)])
        self._copy_page(Bound(cache), pages)
        return cache

    def set_positions(self, cache, slots, value: int):
        """Set the cursors of ``slots`` to ``value``, in place (the
        captured steps read ``pos`` at its address): a beam's sibling
        lanes start at the root's context length without a prefill."""
        (idx,) = self._stage(np.asarray(slots).reshape(-1))
        cache["pos"].index_fill_(0, idx, int(value))
        return cache

    @torch.no_grad()
    def prefill(self, cache, tokens, lengths=None):
        """Prefill the whole dense pool: ``tokens`` (B, T) with B == cache
        slots; ``lengths`` (B,) defaults to T per row. Returns
        (last-position logits (B, V) f32, cache)."""
        if kvcache.is_paged(cache):
            raise ValueError(
                "prefill is the dense-pool path; a paged cache admits via "
                "prefill_chunk")
        tokens = np.asarray(tokens, np.int64)
        if tokens.ndim != 2:
            raise ValueError(f"prefill wants (B, T) token ids, got shape "
                             f"{tokens.shape}")
        b, t = tokens.shape
        if t > self.max_len or t > kvcache.cache_len(cache):
            raise ValueError(f"prompt length {t} exceeds the cache "
                             f"capacity max_len={self.max_len}")
        if b != kvcache.cache_slots(cache):
            raise ValueError(
                f"prefill batch {b} != cache slots "
                f"{kvcache.cache_slots(cache)} (use prefill_slot for "
                "single-request admission)")
        if lengths is None:
            lengths = np.full((b,), t, np.int64)
        toks, lens = self._stage(tokens, np.asarray(lengths).reshape(b))
        return self._prefill(Bound(cache), toks, lens), cache

    @torch.no_grad()
    def prefill_slot(self, cache, tokens, slot: int):
        """Admit one 1-D prompt into ``slot``, padded to the next prefill
        bucket. Only this slot's rows and cursor change. Returns (last
        logits (V,), cache)."""
        if kvcache.is_paged(cache):
            raise ValueError(
                "prefill_slot is the dense-pool admission path; a paged "
                "cache admits via prefill_chunk")
        tokens = np.asarray(tokens, np.int64).reshape(-1)
        n = tokens.shape[0]
        if n < 1:
            raise ValueError("empty prompt")
        if n > self.max_len:
            raise ValueError(f"prompt length {n} exceeds cache capacity "
                             f"max_len={self.max_len}")
        if not 0 <= int(slot) < kvcache.cache_slots(cache):
            raise ValueError(f"slot {slot} outside the "
                             f"{kvcache.cache_slots(cache)}-slot pool")
        bucket = next(b for b in self.prefill_buckets if b >= n)
        if bucket > kvcache.cache_len(cache):
            raise ValueError(f"bucket {bucket} exceeds the cache's "
                             f"{kvcache.cache_len(cache)} rows")
        padded = np.zeros((1, bucket), np.int64)
        padded[0, :n] = tokens
        toks, meta = self._stage(padded, [int(slot), n])
        return self._prefill_slot(Bound(cache), toks, meta), cache

    def _paged_entry(self, cache):
        """The paged decode entry point ``decode_step`` runs for ``cache``:
        the gather-dequant body for an int8 pool, else K2's or the gather
        body's by :meth:`_paged_kernel_choice`."""
        if kvcache.is_quantized(cache) or \
                self._paged_kernel_choice(cache) != "kernel":
            return self._decode_paged
        return self._decode_paged_kernel

    def _paged_kernel_choice(self, cache) -> str:
        """``"kernel"`` or ``"gather"`` for this cache geometry — resolved
        once per (pool shape, dtype, table shape, device) and memoized, so
        the decode loop never decides again."""
        key = (tuple(cache["k"].shape), cache["k"].dtype,
               tuple(cache["pages"].shape), cache["k"].device)
        got = self._paged_plan.get(key)
        if got is None:
            got = self._paged_plan[key] = pa.decide(self, cache)
        return got

    @torch.no_grad()
    def decode_step(self, cache, tokens):
        """One token for every slot: tokens (B,) → (logits (B, V) f32,
        cache). Dispatches on the cache layout — dense lanes, or the
        paged pool via the gather path or the CUDA kernel (an int8 pool:
        the gather-dequant path) — with the decode weight set
        (:meth:`_decode_params`)."""
        (tokens,) = self._stage(np.asarray(tokens).reshape(-1))
        if tokens.shape[0] != kvcache.cache_slots(cache):
            raise ValueError(f"decode_step wants one token per slot "
                             f"({kvcache.cache_slots(cache)}), got "
                             f"{tokens.shape[0]}")
        fn = self._paged_entry(cache) if kvcache.is_paged(cache) \
            else self._decode
        return fn(Bound(cache), tokens, self._decode_params()), cache

    @torch.no_grad()
    def prefill_chunk(self, cache, tokens, slot: int, start: int = 0):
        """Write one chunk of a slot's context (rows ``[start,
        start+len)``, at most ``chunk_len``) into its mapped pages — every
        position up to ``start+len`` must already be mapped (the
        scheduler's job). Pads to a chunk bucket. Returns (last logits
        (V,), cache); the logits matter only on the final chunk."""
        if not kvcache.is_paged(cache):
            raise ValueError("prefill_chunk needs a paged cache "
                             "(init_paged_cache); dense pools admit via "
                             "prefill_slot")
        return self._chunk(self._prefill_chunk, cache, tokens, slot, start)

    @torch.no_grad()
    def verify_chunk(self, cache, tokens, slot: int, start: int = 0):
        """The ``prefill_chunk`` dispatch with the head over EVERY row:
        returns ((C_bucket, V) f32 logits, cache); row i is the
        next-token distribution after ``tokens[:i+1]`` (a SCORE request
        scores its prompt from them). Rows are written into the slot's
        mapped pages as in ``prefill_chunk``; rows past ``len(tokens)``
        are garbage the caller slices off. Runs the decode weight set
        (:meth:`_decode_params`): the verify logits are the ones
        ``decode_step`` would give, so greedy speculation stays
        identical to plain decode."""
        if not kvcache.is_paged(cache):
            raise ValueError("verify_chunk needs a paged cache: rollback "
                             "is a page-table operation")
        return self._chunk(self._verify_chunk, cache, tokens, slot, start,
                           self._decode_params())

    @torch.no_grad()
    def embed_chunk(self, cache, tokens, slot: int, start: int = 0):
        """The ``prefill_chunk`` dispatch with the head swapped for the
        post-``ln_f`` hidden rows: returns ((C_bucket, d) f32, cache);
        rows past ``len(tokens)`` are garbage the caller slices off."""
        if not kvcache.is_paged(cache):
            raise ValueError("embed_chunk needs a paged cache "
                             "(init_paged_cache)")
        return self._chunk(self._embed_chunk, cache, tokens, slot, start)

    def _chunk(self, fn, cache, tokens, slot, start, *static):
        """Check, pad to a chunk bucket and stage one chunk for ``fn`` (a
        chunk entry point; ``static`` its trailing static arguments)."""
        tokens = np.asarray(tokens, np.int64).reshape(-1)
        n = tokens.shape[0]
        if n < 1:
            raise ValueError("empty chunk")
        if n > self.chunk_len:
            raise ValueError(f"chunk of {n} tokens exceeds chunk_len="
                             f"{self.chunk_len}")
        if start < 0 or start + n > self.max_len:
            raise ValueError(f"chunk ends at {start + n}, past cache "
                             f"capacity max_len={self.max_len}")
        if not 0 <= int(slot) < kvcache.cache_slots(cache):
            raise ValueError(f"slot {slot} outside the "
                             f"{kvcache.cache_slots(cache)}-slot pool")
        bucket = next(b for b in self.chunk_buckets if b >= n)
        padded = np.zeros((bucket,), np.int64)
        padded[:n] = tokens
        toks, meta = self._stage(padded, [int(slot), int(start), n])
        return fn(Bound(cache), toks, meta, *static), cache

    def make_generator(self, seed: int = 0) -> torch.Generator:
        """A ``torch.Generator`` on the engine's device."""
        return torch.Generator(device=self.device).manual_seed(int(seed))

    def _seed0_generator(self) -> torch.Generator:
        """The engine's own generator, reseeded to 0: what a call that
        passes no generator draws from — the draws of a fresh seed-0
        generator, through the one sampled signature a graph holds
        (a sampled graph holds its generator)."""
        if self._default_gen is None:
            self._default_gen = self.make_generator()
        return self._default_gen.manual_seed(0)

    @torch.no_grad()
    def sample(self, logits, temperature=0.0, top_k=0, generator=None):
        """Next tokens (B,) int32 from (B, V) logits; scalar knobs
        broadcast to the batch, vectors give per-slot control. Greedy
        (every temperature <= 0) and sampled calls are two signatures; a
        sampled one draws from ``generator`` (by default what a fresh
        seed-0 generator draws) inside its graph."""
        temperature = np.broadcast_to(
            np.asarray(temperature, np.float32), (logits.shape[0],))
        if not (temperature > 0).any():
            return self._sample(logits, None, None, None)
        return self._sample(logits, *self._sampling_args(
            logits.shape[0], temperature, top_k, generator))

    @torch.no_grad()
    def sample_masked(self, logits, temperature=0.0, top_k=0,
                      generator=None, mask=None):
        """:meth:`sample` through the masked sampler: ``mask`` (B, V) or
        (V,) bool, True admits the token. ``mask=None`` is the plain
        :meth:`sample`. One signature a batch size (greedy and tempered
        rows alike); an all-true mask gives :meth:`sample`'s greedy
        tokens bit for bit."""
        if mask is None:
            return self.sample(logits, temperature, top_k, generator)
        (m,) = self._stage(np.broadcast_to(np.asarray(mask, bool),
                                           logits.shape), dtype=np.bool_)
        return self._sample_masked(logits, *self._sampling_args(
            logits.shape[0], temperature, top_k, generator), m)

    def _sampling_args(self, bsz, temperature, top_k, generator):
        """A sampled call's per-row temperature and top-k, broadcast to
        the batch ``bsz`` and staged on the device, and its bound
        generator (by default what a fresh seed-0 generator draws)."""
        temperature = np.broadcast_to(
            np.asarray(temperature, np.float32), (bsz,))
        top_k = np.broadcast_to(np.asarray(top_k, np.int64), (bsz,))
        if generator is None:
            generator = self._seed0_generator()
        (k,) = self._stage(top_k)
        (t,) = self._stage(temperature, dtype=np.float32)
        return t, k, Bound(generator)

    def generate(self, prompt_ids, max_new_tokens=32, *, generator=None,
                 temperature=0.0, top_k=0, eos_id=None):
        """One-shot batched generation: prefill the prompt(s), then
        sample/decode up to ``max_new_tokens``. Returns generated ids
        (prompt excluded) as numpy — ``(B, n)`` (rows past their eos are
        padded with ``eos_id``) or ``(n,)`` for a 1-D prompt."""
        ids = np.asarray(prompt_ids, np.int32)
        squeeze = ids.ndim == 1
        if squeeze:
            ids = ids[None, :]
        if ids.ndim != 2 or ids.shape[1] < 1:
            raise ValueError(f"prompt_ids must be (T,) or (B, T) with "
                             f"T >= 1, got shape {ids.shape}")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        bsz, t = ids.shape
        # the last sampled token is never written back, hence the -1
        if t + max_new_tokens - 1 > self.max_len:
            raise ValueError(
                f"prompt ({t}) + max_new_tokens ({max_new_tokens}) - 1 "
                f"exceeds cache capacity max_len={self.max_len}")
        if generator is None:
            generator = self._seed0_generator()
        cache = self.init_cache(bsz)
        logits, cache = self.prefill(cache, ids)
        out = np.zeros((bsz, max_new_tokens), np.int32)
        done = np.zeros((bsz,), bool)
        pad = 0 if eos_id is None else int(eos_id)
        n = 0
        for i in range(max_new_tokens):
            toks = self.sample(logits, temperature, top_k,
                               generator).cpu().numpy()
            out[:, i] = np.where(done, pad, toks)
            n = i + 1
            if eos_id is not None:
                done |= (toks == eos_id)
                if done.all():
                    break
            if i + 1 < max_new_tokens:
                logits, cache = self.decode_step(cache, toks)
        out = out[:, :n]
        return out[0] if squeeze else out
