"""Decoder-only transformer LM with KV-cache serving (the counterpart of
``aesara_tpu/models/decoder.py``, built from the same code).

``DecoderLM.generate_fn()`` compiles the whole decode loop (embedding, L
causal layers reading and writing per-layer KV caches, the LM head and
greedy argmax) into one function: a ``scan`` whose carry holds the
token, the position and the (T_max, H, dh) K/V caches of each layer,
updated with ``set_subtensor``.  On the card the loop's steps are one
captured CUDA graph, and the Scan lowering writes each new K/V row in
place into the loop's own cache buffer (``link/torch/scan_dispatch.py``),
as XLA updates the donated carry in place: no cache copy per step.

``temperature > 0`` samples by Gumbel-max with a key threaded through the
loop (one threefry draw a step, ``tensor/random``), ``top_k`` masks the
logits below the k-th largest first; ``speculative_generate_fn`` verifies
a draft model's proposals in a while-Scan, which runs eagerly (its
``until`` is read on the host each round); ``beam_search_fn`` keeps
per-beam caches reordered by parent each step and backtraces on the host.
"""

from __future__ import annotations

import numpy as np

from aesara_tpu_torch.config import config
from aesara_tpu_torch.models.base import Model, glorot, zeros
from aesara_tpu_torch.tensor import math as tm
from aesara_tpu_torch.tensor.basic import alloc, arange, as_tensor_variable, cast, constant, join, switch
from aesara_tpu_torch.tensor.extra_ops import broadcast_to, cumprod, repeat as t_repeat
from aesara_tpu_torch.tensor.random.utils import RandomStream
from aesara_tpu_torch.tensor.shape import shape as tshape
from aesara_tpu_torch.tensor.sort import argtopk, topk as t_topk
from aesara_tpu_torch.tensor.special import softmax
from aesara_tpu_torch.tensor.subtensor import DynamicIncSubtensor, set_subtensor

__all__ = ["TransformerDecoderLayer", "DecoderLM"]


def _dim(x, i: int):
    """``x.shape[i]`` as the JAX package builds it: a ``Shape`` indexed by
    a ``Subtensor`` (the port's ``x.shape`` gives a static dim as a
    constant), so that the two packages' graphs agree node for node."""
    return tshape(x)[i]


def _host(value) -> np.ndarray:
    """A function's result on the host, for the beam's backtrace."""
    return value.detach().cpu().numpy() if hasattr(value, "detach") else np.asarray(value)


def _layer_norm(x, gain, bias, eps=1e-5):
    mu = tm.mean(x, axis=-1, keepdims=True)
    var = tm.mean(tm.sqr(x - mu), axis=-1, keepdims=True)
    return gain * (x - mu) / tm.sqrt(var + eps) + bias


class TransformerDecoderLayer(Model):
    """Pre-LN causal decoder layer (no cross-attention).

    Two entry points: ``full(x)`` for training/prefill over (T, D), and
    ``step(h, k_cache, v_cache, pos)`` for one cached decode step.

    ``n_kv_heads`` < ``n_heads`` gives grouped-query attention (GQA,
    Ainslie et al. 2023): query head ``h`` attends through KV head
    ``h // (n_heads // n_kv_heads)`` — the KV caches shrink by the
    group factor, the decisive memory knob for long-context serving.
    Default (None) is standard multi-head attention.
    """

    def __init__(self, d_model: int, n_heads: int, d_ff: int, seed: int = 0,
                 n_kv_heads: int | None = None):
        super().__init__()
        assert d_model % n_heads == 0
        rng = np.random.default_rng(seed)
        self.d_model, self.n_heads = d_model, n_heads
        self.d_head = d_model // n_heads
        self.n_kv_heads = n_kv_heads if n_kv_heads is not None else n_heads
        assert n_heads % self.n_kv_heads == 0
        self.q_per_kv = n_heads // self.n_kv_heads
        kv_width = self.n_kv_heads * self.d_head
        self.wq = self._register(glorot(rng, d_model, d_model, "wq"))
        self.wk = self._register(glorot(rng, d_model, kv_width, "wk"))
        self.wv = self._register(glorot(rng, d_model, kv_width, "wv"))
        self.wo = self._register(glorot(rng, d_model, d_model, "wo"))
        self.w1 = self._register(glorot(rng, d_model, d_ff, "w1"))
        self.b1 = self._register(zeros((d_ff,), "b1"))
        self.w2 = self._register(glorot(rng, d_ff, d_model, "w2"))
        self.b2 = self._register(zeros((d_model,), "b2"))
        self.ln1_g = self._register(zeros((d_model,), "ln1_g"))
        self.ln1_b = self._register(zeros((d_model,), "ln1_b"))
        self.ln2_g = self._register(zeros((d_model,), "ln2_g"))
        self.ln2_b = self._register(zeros((d_model,), "ln2_b"))
        for g in (self.ln1_g, self.ln2_g):
            g.set_value(np.ones(d_model, dtype=g.get_value().dtype))

    # -- training / prefill: (T, D) with a causal mask ---------------------
    def full(self, x):
        T = _dim(x, 0)
        z = _layer_norm(x, self.ln1_g, self.ln1_b)
        H, dh, Kv = self.n_heads, self.d_head, self.n_kv_heads
        q = tm.dot(z, self.wq).reshape((T, H, dh)).dimshuffle(1, 0, 2)
        k = tm.dot(z, self.wk).reshape((T, Kv, dh)).dimshuffle(1, 0, 2)
        v = tm.dot(z, self.wv).reshape((T, Kv, dh)).dimshuffle(1, 0, 2)
        if Kv != H:
            # GQA: head h reads KV head h // q_per_kv (head layout
            # h = kv*q_per_kv + g, matching np.repeat along heads)
            k = t_repeat(k, self.q_per_kv, axis=0)
            v = t_repeat(v, self.q_per_kv, axis=0)
        scores = tm.batched_dot(q, k.dimshuffle(0, 2, 1)) / np.sqrt(dh)
        rows = arange(T).dimshuffle("x", 0, "x")
        cols = arange(T).dimshuffle("x", "x", 0)
        neg = constant(np.asarray(-1e9, dtype=config.floatX))
        scores = switch(tm.ge(rows, cols), scores, neg)
        attn = softmax(scores, axis=-1)
        ctx = tm.batched_dot(attn, v).dimshuffle(1, 0, 2).reshape(
            (T, self.d_model)
        )
        h = x + tm.dot(ctx, self.wo)
        z2 = _layer_norm(h, self.ln2_g, self.ln2_b)
        ffn = tm.dot(tm.maximum(tm.dot(z2, self.w1) + self.b1, 0.0),
                     self.w2) + self.b2
        return h + ffn

    # -- cached decode: one token against the cache ------------------------
    def step(self, h, k_cache, v_cache, pos):
        """h (D,); caches (T_max, n_kv_heads, dh); pos int scalar.
        Returns (h_out, new_k_cache, new_v_cache)."""
        dh, Kv, G = self.d_head, self.n_kv_heads, self.q_per_kv
        z = _layer_norm(h, self.ln1_g, self.ln1_b)
        q = tm.dot(z, self.wq).reshape((Kv, G, dh))
        k_new = tm.dot(z, self.wk).reshape((Kv, dh))
        v_new = tm.dot(z, self.wv).reshape((Kv, dh))
        k_cache = set_subtensor(k_cache[pos], k_new)
        v_cache = set_subtensor(v_cache[pos], v_new)
        # scores over the whole static cache, masked beyond pos
        scores = tm.sum(
            k_cache.dimshuffle(0, 1, "x", 2) * q.dimshuffle("x", 0, 1, 2),
            axis=-1,
        ) / np.sqrt(dh)                                   # (T_max, Kv, G)
        t_idx = arange(_dim(k_cache, 0)).dimshuffle(0, "x", "x")
        neg = constant(np.asarray(-1e9, dtype=config.floatX))
        scores = switch(tm.le(t_idx, pos), scores, neg)
        attn = softmax(scores, axis=0)                    # over time
        ctx = tm.sum(
            attn.dimshuffle(0, 1, 2, "x") * v_cache.dimshuffle(0, 1, "x", 2),
            axis=0,
        )                                                  # (Kv, G, dh)
        h = h + tm.dot(ctx.reshape((self.d_model,)), self.wo)
        z2 = _layer_norm(h, self.ln2_g, self.ln2_b)
        ffn = tm.dot(tm.maximum(tm.dot(z2, self.w1) + self.b1, 0.0),
                     self.w2) + self.b2
        return h + ffn, k_cache, v_cache


    # -- prefill helper: the K/V rows a (length, D) prefix contributes ------
    def prefill_kv_rows(self, h, length):
        """K/V cache rows for a (length, D) hidden prefix: per-position
        projections of the LN'd input — EXACTLY what full()/step()
        compute, shared by every prefill path (decode, continuous
        batching) so the cache layout cannot desynchronize."""
        z = _layer_norm(h, self.ln1_g, self.ln1_b)
        Kv, dh = self.n_kv_heads, self.d_head
        return (
            tm.dot(z, self.wk).reshape((length, Kv, dh)),
            tm.dot(z, self.wv).reshape((length, Kv, dh)),
        )

    # -- cached block decode: G tokens at positions pos..pos+G-1 -----------
    def step_block(self, hs, k_cache, v_cache, pos, block: int):
        """hs (G, D) embeddings of G consecutive tokens at positions
        ``pos..pos+G-1``; caches (T_max, n_kv_heads, dh); pos int
        scalar; ``block`` = static G.  Returns (hs_out, k_cache,
        v_cache).  The verify pass of speculative decoding: ONE batched
        batched pass scores all G positions against the cache with a
        per-row causal mask (row g sees cache rows t <= pos+g), writing
        the G new K/V rows at ``pos:pos+G`` (a dynamic-slice window)."""
        dh, Kv, G = self.d_head, self.n_kv_heads, self.q_per_kv
        B = block
        z = _layer_norm(hs, self.ln1_g, self.ln1_b)
        q = tm.dot(z, self.wq).reshape((B, Kv, G, dh))
        k_new = tm.dot(z, self.wk).reshape((B, Kv, dh))
        v_new = tm.dot(z, self.wv).reshape((B, Kv, dh))
        # runtime offset, static window: lax.dynamic_update_slice
        _set_block = DynamicIncSubtensor((B,), set_instead_of_inc=True)
        k_cache = _set_block(k_cache, k_new, pos)
        v_cache = _set_block(v_cache, v_new, pos)
        # scores[t, kv, g, b] = k_cache[t,kv,:] . q[b,kv,g,:]
        scores = tm.sum(
            k_cache.dimshuffle(0, 1, "x", "x", 2)
            * q.dimshuffle("x", 1, 2, 0, 3),
            axis=-1,
        ) / np.sqrt(dh)                               # (T_max, Kv, G, B)
        t_idx = arange(_dim(k_cache, 0)).dimshuffle(0, "x", "x", "x")
        b_idx = arange(B).dimshuffle("x", "x", "x", 0)
        neg = constant(np.asarray(-1e9, dtype=config.floatX))
        scores = switch(tm.le(t_idx, pos + b_idx), scores, neg)
        attn = softmax(scores, axis=0)                # over time
        ctx = tm.sum(
            attn.dimshuffle(0, 1, 2, 3, "x")
            * v_cache.dimshuffle(0, 1, "x", "x", 2),
            axis=0,
        )                                             # (Kv, G, B, dh)
        ctx = ctx.dimshuffle(2, 0, 1, 3).reshape((B, self.d_model))
        h = hs + tm.dot(ctx, self.wo)
        z2 = _layer_norm(h, self.ln2_g, self.ln2_b)
        ffn = tm.dot(tm.maximum(tm.dot(z2, self.w1) + self.b1, 0.0),
                     self.w2) + self.b2
        return h + ffn, k_cache, v_cache

    # -- batched cached decode with PER-STREAM positions --------------------
    def step_batched_pos(self, h, k_cache, v_cache, pos):
        """Like ``step_batched`` but ``pos`` is a (B,) int64 VECTOR: each
        stream decodes at its own position — the continuous-batching
        core, where admitted requests are at different depths.  Row b
        attends to cache rows ``t <= pos[b]`` and writes its new K/V at
        ``[b, pos[b]]``."""
        dh, Kv, G = self.d_head, self.n_kv_heads, self.q_per_kv
        z = _layer_norm(h, self.ln1_g, self.ln1_b)
        B = _dim(h, 0)
        q = tm.dot(z, self.wq).reshape((B, Kv, G, dh))
        k_new = tm.dot(z, self.wk).reshape((B, Kv, dh))
        v_new = tm.dot(z, self.wv).reshape((B, Kv, dh))
        # per-row writes as a fused one-hot SELECT, not a scatter with
        # run-time (b, pos[b]) indices, as the JAX package builds it (a
        # scatter serializes on its TPU): the masked rewrite reads and
        # writes the cache once, one K1 launch
        t_sel = arange(_dim(k_cache, 1)).dimshuffle("x", 0, "x", "x")
        write = tm.eq(t_sel, pos.dimshuffle(0, "x", "x", "x"))
        k_cache = cast(
            switch(write, k_new.dimshuffle(0, "x", 1, 2), k_cache),
            k_cache.type.dtype,
        )
        v_cache = cast(
            switch(write, v_new.dimshuffle(0, "x", 1, 2), v_cache),
            v_cache.type.dtype,
        )
        scores = tm.sum(
            k_cache.dimshuffle(0, 1, 2, "x", 3)
            * q.dimshuffle(0, "x", 1, 2, 3),
            axis=-1,
        ) / np.sqrt(dh)                                   # (B, T, Kv, G)
        neg = constant(np.asarray(-1e9, dtype=config.floatX))
        scores = switch(
            tm.le(t_sel, pos.dimshuffle(0, "x", "x", "x")), scores, neg
        )
        attn = softmax(scores, axis=1)                    # over time
        ctx = tm.sum(
            attn.dimshuffle(0, 1, 2, 3, "x")
            * v_cache.dimshuffle(0, 1, 2, "x", 3),
            axis=1,
        )                                                  # (B, Kv, G, dh)
        h = h + tm.dot(ctx.reshape((B, self.d_model)), self.wo)
        z2 = _layer_norm(h, self.ln2_g, self.ln2_b)
        ffn = tm.dot(tm.maximum(tm.dot(z2, self.w1) + self.b1, 0.0),
                     self.w2) + self.b2
        return h + ffn, k_cache, v_cache

    # -- batched cached decode: B synchronized streams ---------------------
    def step_batched(self, h, k_cache, v_cache, pos):
        """h (B, D); caches (B, T_max, n_kv_heads, dh); pos int scalar.
        Returns (h_out, new_k_cache, new_v_cache).  All B streams decode
        in lockstep (continuous batching's fixed-shape core): the (B,
        d)·(d, d) projections batch into one product instead of B
        matvecs — the throughput lever serving stacks rely on."""
        dh, Kv, G = self.d_head, self.n_kv_heads, self.q_per_kv
        z = _layer_norm(h, self.ln1_g, self.ln1_b)
        B = _dim(h, 0)
        q = tm.dot(z, self.wq).reshape((B, Kv, G, dh))
        k_new = tm.dot(z, self.wk).reshape((B, Kv, dh))
        v_new = tm.dot(z, self.wv).reshape((B, Kv, dh))
        k_cache = set_subtensor(k_cache[:, pos], k_new)
        v_cache = set_subtensor(v_cache[:, pos], v_new)
        scores = tm.sum(
            k_cache.dimshuffle(0, 1, 2, "x", 3)
            * q.dimshuffle(0, "x", 1, 2, 3),
            axis=-1,
        ) / np.sqrt(dh)                                   # (B, T, Kv, G)
        t_idx = arange(_dim(k_cache, 1)).dimshuffle("x", 0, "x", "x")
        neg = constant(np.asarray(-1e9, dtype=config.floatX))
        scores = switch(tm.le(t_idx, pos), scores, neg)
        attn = softmax(scores, axis=1)                    # over time
        ctx = tm.sum(
            attn.dimshuffle(0, 1, 2, 3, "x")
            * v_cache.dimshuffle(0, 1, 2, "x", 3),
            axis=1,
        )                                                  # (B, Kv, G, dh)
        h = h + tm.dot(ctx.reshape((B, self.d_model)), self.wo)
        z2 = _layer_norm(h, self.ln2_g, self.ln2_b)
        ffn = tm.dot(tm.maximum(tm.dot(z2, self.w1) + self.b1, 0.0),
                     self.w2) + self.b2
        return h + ffn, k_cache, v_cache


class DecoderLM(Model):
    """Embedding + L decoder layers + tied LM head."""

    def __init__(self, vocab: int, n_layers: int, d_model: int,
                 n_heads: int, d_ff: int, seed: int = 0,
                 n_kv_heads: int | None = None):
        super().__init__()
        rng = np.random.default_rng(seed)
        self.vocab, self.d_model = vocab, d_model
        self.embed = self._register(glorot(rng, vocab, d_model, "embed"))
        self.layers = [
            TransformerDecoderLayer(d_model, n_heads, d_ff, seed=seed + 1 + i,
                                    n_kv_heads=n_kv_heads)
            for i in range(n_layers)
        ]
        for layer in self.layers:
            self._register(*layer.params)

    # -- training loss: next-token xent over a (T,) int sequence -----------
    def loss(self, tokens):
        x = self.embed[tokens[:-1]]                   # (T-1, D)
        h = x
        for layer in self.layers:
            h = layer.full(h)
        logits = tm.dot(h, self.embed.T)              # tied head
        logp = logits - tm.logsumexp(logits, axis=-1, keepdims=True)
        idx = arange(_dim(logp, 0))
        return -tm.mean(logp[idx, tokens[1:]])

    # -- serving: greedy/temperature generation as ONE program -------------
    def generate_graph(self, first_token, n_steps: int, t_max: int,
                      temperature: float = 0.0, seed: int = 0,
                      top_k: int = 0):
        """Symbolic generation of ``n_steps`` tokens from ``first_token``
        (int scalar variable).  Returns the generated int64 vector (length
        n_steps).  temperature=0 is greedy argmax; > 0 is Gumbel-max
        sampling from a stream of fixed ``seed``; ``top_k`` > 0 keeps
        the k highest logits (a static-shape mask: logits below the k-th
        value are set to -1e9 before the noise)."""
        from aesara_tpu_torch.scan.basic import scan

        if n_steps > t_max:
            raise ValueError(
                f"generate: n_steps ({n_steps}) exceeds the cache bound "
                f"t_max ({t_max}) — a write past the cache would be an "
                f"out-of-range index on the device"
            )
        L = len(self.layers)
        Kv, dh = self.layers[0].n_kv_heads, self.layers[0].d_head
        fX = config.floatX

        caches = []
        for i in range(L):
            for kind in ("k", "v"):
                caches.append(
                    alloc(constant(np.asarray(0, dtype=fX)), t_max, Kv, dh)
                )

        def step_fn(tok, pos, *cache_args):
            caches = list(cache_args)
            h = self.embed[tok]
            new_caches = []
            for i, layer in enumerate(self.layers):
                h, kc, vc = layer.step(h, caches[2 * i], caches[2 * i + 1],
                                       pos)
                new_caches += [kc, vc]
            logits = tm.dot(h, self.embed.T)
            if temperature > 0.0:
                if top_k and top_k > 0:
                    # static-shape top-k truncation: mask logits below
                    # the k-th largest before the noise
                    kth = tm.min(t_topk(logits, int(top_k)))
                    neg = constant(np.asarray(-1e9, dtype=fX))
                    logits = switch(tm.ge(logits, kth), logits, neg)
                # Gumbel noise from a key of fixed seed, threaded through
                # the loop (scan carries the stream's default update)
                srng = RandomStream(seed=seed)
                u = srng.uniform(low=1e-6, high=1.0 - 1e-6, size=(self.vocab,))
                logits = logits / np.asarray(temperature, dtype=fX) - tm.log(-tm.log(u))
            nxt = cast(tm.argmax(logits), "int64")
            return (nxt, pos + np.int64(1), *new_caches)

        outs, _ = scan(
            fn=step_fn,
            outputs_info=[cast(as_tensor_variable(first_token), "int64"),
                          constant(np.int64(0))] + caches,
            n_steps=n_steps,
        )
        tokens = outs[0] if isinstance(outs, (list, tuple)) else outs
        return tokens

    def generate_fn(self, n_steps: int, t_max: int, temperature: float = 0.0,
                    top_k: int = 0, mode=None):
        """Compile ``first_token -> generated int64 vector``."""
        from aesara_tpu_torch.compile.function import function
        from aesara_tpu_torch.tensor.type import lscalar

        tok0 = lscalar("tok0")
        toks = self.generate_graph(tok0, n_steps, t_max, temperature,
                                   top_k=top_k)
        return function([tok0], toks, mode=mode)

    # -- prompt serving: prefill the caches, then decode -------------------
    def prefill_graph(self, prompt, prompt_len: int, t_max: int):
        """Run the batched full-sequence forward over ``prompt`` (int
        vector, static length ``prompt_len``) while FILLING the KV
        caches — one batched pass instead of ``prompt_len`` decode
        steps (the prefill/decode split every serving stack makes).
        Returns (last_hidden, caches): caches are (t_max, H, dh) per
        layer with rows [0, prompt_len) populated."""
        if prompt_len > t_max:
            raise ValueError(
                f"prefill: prompt_len ({prompt_len}) exceeds t_max ({t_max})"
            )
        Kv, dh = self.layers[0].n_kv_heads, self.layers[0].d_head
        fX = config.floatX
        x = self.embed[prompt]                       # (P, D)
        caches = []
        h = x
        for layer in self.layers:
            k_rows, v_rows = layer.prefill_kv_rows(h, prompt_len)
            kc = alloc(constant(np.asarray(0, dtype=fX)), t_max, Kv, dh)
            vc = alloc(constant(np.asarray(0, dtype=fX)), t_max, Kv, dh)
            caches.append(set_subtensor(kc[:prompt_len], k_rows))
            caches.append(set_subtensor(vc[:prompt_len], v_rows))
            h = layer.full(h)
        return h[-1], caches

    def generate_from_prompt_fn(self, prompt_len: int, n_new: int,
                                t_max: int, mode=None):
        """Compile ``prompt (int64 vector, len prompt_len) -> n_new
        generated tokens``: ONE program containing the batched prefill
        AND the decode scan."""
        from aesara_tpu_torch.compile.function import function
        from aesara_tpu_torch.scan.basic import scan
        from aesara_tpu_torch.tensor.type import TensorType

        if prompt_len + n_new > t_max:
            raise ValueError(
                f"prompt_len + n_new ({prompt_len + n_new}) exceeds "
                f"t_max ({t_max})"
            )
        prompt = TensorType("int64", (prompt_len,))("prompt")
        h_last, caches = self.prefill_graph(prompt, prompt_len, t_max)
        logits0 = tm.dot(h_last, self.embed.T)
        tok0 = cast(tm.argmax(logits0), "int64")

        def step_fn(tok, pos, *cache_args):
            caches = list(cache_args)
            h = self.embed[tok]
            new_caches = []
            for i, layer in enumerate(self.layers):
                h, kc, vc = layer.step(h, caches[2 * i], caches[2 * i + 1],
                                       pos)
                new_caches += [kc, vc]
            logits = tm.dot(h, self.embed.T)
            nxt = cast(tm.argmax(logits), "int64")
            return (nxt, pos + np.int64(1), *new_caches)

        if n_new == 1:
            return function([prompt], tok0.dimshuffle("x"), mode=mode)
        outs, _ = scan(
            fn=step_fn,
            outputs_info=[tok0, constant(np.int64(prompt_len))] + caches,
            n_steps=n_new - 1,
        )
        cont = outs[0] if isinstance(outs, (list, tuple)) else outs
        # output = tok0 (from the prefill logits) + the n_new-1 decoded
        # continuations
        toks = join(0, tok0.dimshuffle("x"), cont)
        return function([prompt], toks, mode=mode)

    # -- speculative decoding ----------------------------------------------
    def speculative_generate_fn(self, draft: "DecoderLM", prompt_len: int,
                                n_new: int, t_max: int, n_spec: int = 4,
                                mode=None):
        """Greedy speculative decoding: a small ``draft`` model proposes
        ``n_spec`` tokens a round, this (target) model verifies them in
        one batched ``step_block`` pass, and the longest matching prefix
        commits: every emitted token is the target's own greedy choice, so
        the output is the target's sequential decode up to reduction
        order (the batched verify pass and the sequential step compute the
        same logits through different reductions, so a near tie between
        the top two logits may flip an argmax between them; Leviathan et
        al. 2023, greedy variant).

        Compiles ``prompt (int64, len prompt_len) -> n_new tokens``: both
        models' prefills, then a while-Scan over rounds whose carry holds
        the output buffer, the write pointer, the current token and
        position, and both models' KV caches.  Every round writes a fixed
        n_spec-wide block into the buffer and advances the pointer by the
        accepted count (1..n_spec), a scalar on the device.  The loop's
        ``until`` is read on the host after each round, so the function
        runs eagerly on the card (``capture_blocker`` says so)."""
        from aesara_tpu_torch.compile.function import function
        from aesara_tpu_torch.scan.basic import scan, until
        from aesara_tpu_torch.tensor.type import TensorType

        if draft.vocab != self.vocab:
            raise ValueError("draft and target must share a vocabulary")
        if prompt_len + n_new + n_spec > t_max:
            raise ValueError(
                f"prompt_len + n_new + n_spec ({prompt_len + n_new + n_spec})"
                f" exceeds t_max ({t_max})"
            )
        G = int(n_spec)
        if G < 1:
            raise ValueError("n_spec must be >= 1")

        prompt = TensorType("int64", (prompt_len,))("prompt")
        # both models prefill their caches on the prompt
        h_last_t, t_caches = self.prefill_graph(prompt, prompt_len, t_max)
        _, d_caches = draft.prefill_graph(prompt, prompt_len, t_max)
        tok0 = cast(tm.argmax(tm.dot(h_last_t, self.embed.T)), "int64")

        Ld = len(draft.layers)
        buf0 = alloc(constant(np.int64(0)), n_new + G)
        zero = constant(np.int64(0))

        def round_fn(buf, n_done, cur, pos, *cache_args):
            cache_args = list(cache_args)
            dc = cache_args[: 2 * Ld]
            tc = cache_args[2 * Ld:]

            # 1. draft proposes G tokens autoregressively (unrolled; its
            #    first step consumes `cur` at position `pos`)
            proposals = []
            tok, dpos = cur, pos
            for _ in range(G):
                h = draft.embed[tok]
                new_dc = []
                for i, layer in enumerate(draft.layers):
                    h, kc, vc = layer.step(h, dc[2 * i], dc[2 * i + 1], dpos)
                    new_dc += [kc, vc]
                dc = new_dc
                tok = cast(tm.argmax(tm.dot(h, draft.embed.T)), "int64")
                proposals.append(tok)
                dpos = dpos + np.int64(1)

            # 2. target verifies the block [cur, p_1..p_{G-1}] in one pass
            block_toks = join(
                0, cur.dimshuffle("x"),
                *[p.dimshuffle("x") for p in proposals[:-1]]
            ) if G > 1 else cur.dimshuffle("x")
            hs = self.embed[block_toks]                     # (G, D)
            new_tc = []
            for i, layer in enumerate(self.layers):
                hs, kc, vc = layer.step_block(
                    hs, tc[2 * i], tc[2 * i + 1], pos, block=G
                )
                new_tc += [kc, vc]
            t_toks = cast(
                tm.argmax(tm.dot(hs, self.embed.T), axis=-1), "int64"
            )                                               # (G,)

            # 3. longest matching prefix commits; first mismatch takes
            #    the target's token — j in 1..G tokens commit, all drawn
            #    from t_toks, so the output equals pure target greedy
            if G > 1:
                p_vec = join(0, *[p.dimshuffle("x") for p in proposals[:-1]])
                match = cast(tm.eq(p_vec, t_toks[:G - 1]), "int64")
                lead = cumprod(match)
                j = np.int64(1) + tm.sum(lead)
            else:
                j = constant(np.int64(1))

            buf = DynamicIncSubtensor((G,), set_instead_of_inc=True)(
                buf, t_toks, n_done
            )
            n_done_new = n_done + j
            cur_new = t_toks[j - 1]
            pos_new = pos + j
            # tok0 already counts toward n_new: rounds fill n_new-1
            return (
                buf, n_done_new, cur_new, pos_new, *dc, *new_tc,
                until(tm.ge(n_done_new, np.int64(max(n_new - 1, 1)))),
            )

        outs, _ = scan(
            fn=round_fn,
            outputs_info=[buf0, zero, tok0,
                          constant(np.int64(prompt_len))] + d_caches + t_caches,
            n_steps=n_new,  # each round commits >= 1 token
        )
        final_buf = outs[0][-1]
        toks = join(0, tok0.dimshuffle("x"), final_buf[: n_new - 1]) \
            if n_new > 1 else tok0.dimshuffle("x")
        return function([prompt], toks, mode=mode)

    # -- beam search ---------------------------------------------------------
    def beam_search_fn(self, prompt_len: int, n_new: int, t_max: int,
                       beam: int = 4, mode=None):
        """Fixed-width beam search: one compiled function runs the
        prefill and a scan whose carry holds per-beam scores and per-beam
        KV caches; each step runs all ``beam`` streams through
        ``step_batched``, takes the top ``beam`` of the (beam * V) joint
        scores (equal scores lowest index first) and reorders the caches
        by parent beam with a gather.  The best sequence is assembled by a
        backtrace on the host.  No EOS handling (a fixed horizon): length
        n_new, the greatest total log-probability.

        Returns ``search(prompt) -> (tokens, score)``: the best sequence
        (length n_new) and its summed log-prob; ``search.function`` is the
        compiled function it calls.  With ``beam >= V**i`` at every step i
        the search is exhaustive.
        """
        from aesara_tpu_torch.compile.function import function
        from aesara_tpu_torch.scan.basic import scan
        from aesara_tpu_torch.tensor.type import TensorType

        if prompt_len + n_new > t_max:
            raise ValueError("prompt_len + n_new exceeds t_max")
        if beam < 1:
            raise ValueError("beam must be >= 1")
        V = self.vocab
        K = int(beam)
        Kv, dh = self.layers[0].n_kv_heads, self.layers[0].d_head

        prompt = TensorType("int64", (prompt_len,))("prompt")
        h_last, caches0 = self.prefill_graph(prompt, prompt_len, t_max)
        logits0 = tm.dot(h_last, self.embed.T)
        logp0 = logits0 - tm.logsumexp(logits0)
        # step 1 has only V distinct prefixes: carry the full requested
        # width anyway, the surplus lanes scored -inf, so that they never
        # win a top-k but do host step-2 expansions (beam > V widens the
        # later steps; K = min(beam, V) would not be exhaustive)
        K0 = min(K, V)
        top0 = argtopk(logp0, K0)                     # (K0,) token ids
        toks0 = cast(top0, "int64")
        scores0 = logp0[top0]                          # (K0,)
        if K > K0:
            pad_t = alloc(constant(np.int64(0)), K - K0)
            pad_s = alloc(
                constant(np.asarray(-np.inf, dtype=scores0.type.dtype)),
                K - K0,
            )
            toks0 = join(0, toks0, pad_t)
            scores0 = join(0, scores0, pad_s)
        # per-beam caches: identical prefix for every beam
        bcaches = [
            broadcast_to(c.dimshuffle("x", 0, 1, 2), (K, t_max, Kv, dh)) + 0.0
            for c in caches0
        ]

        def step_fn(cur, scores, pos, *cache_args):
            caches = list(cache_args)
            h = self.embed[cur]                        # (K, D)
            new_caches = []
            for i, layer in enumerate(self.layers):
                h, kc, vc = layer.step_batched(
                    h, caches[2 * i], caches[2 * i + 1], pos
                )
                new_caches += [kc, vc]
            logits = tm.dot(h, self.embed.T)           # (K, V)
            logp = logits - tm.logsumexp(logits, axis=-1, keepdims=True)
            joint = (scores.dimshuffle(0, "x") + logp).flatten()  # (K*V,)
            best = argtopk(joint, K)                   # (K,) flat indices
            parent = best // np.int64(V)
            token = cast(best % np.int64(V), "int64")
            new_scores = joint[best]
            reordered = [c[parent] for c in new_caches]
            new_h_tok = token
            return (new_h_tok, new_scores, pos + np.int64(1),
                    *reordered, parent, token)

        if n_new == 1:
            f = function([prompt], [toks0, scores0], mode=mode)

            def search(pv):
                t, s = (_host(v) for v in f(pv))
                b = int(np.argmax(s))
                return [int(t[b])], float(s[b])

            search.function = f
            return search

        outs, _ = scan(
            fn=step_fn,
            outputs_info=[toks0, scores0, constant(np.int64(prompt_len))]
            + bcaches + [None, None],
            n_steps=n_new - 1,
        )
        parents = outs[-2]                             # (n_new-1, K)
        tokens = outs[-1]                              # (n_new-1, K)
        final_scores = outs[1][-1]                     # (K,)
        f = function([prompt], [tokens, parents, final_scores, toks0],
                     mode=mode)

        def search(pv):
            tk, pr, sc, t0 = (_host(v) for v in f(pv))
            b = int(np.argmax(sc))
            seq = []
            for step in range(tk.shape[0] - 1, -1, -1):
                seq.append(int(tk[step, b]))
                b = int(pr[step, b])
            seq.append(int(t0[b]))
            seq.reverse()
            return seq, float(np.max(sc))

        search.function = f
        return search

    # -- batched serving ---------------------------------------------------
    def generate_batched_graph(self, first_tokens, batch: int, n_steps: int,
                               t_max: int):
        """Greedy decode of B synchronized streams: ``first_tokens``
        (int vector, length B) → (n_steps, B) int64 matrix."""
        from aesara_tpu_torch.scan.basic import scan

        if n_steps > t_max:
            raise ValueError(
                f"generate: n_steps ({n_steps}) exceeds the cache bound "
                f"t_max ({t_max}) — a write past the cache would be an "
                f"out-of-range index on the device"
            )
        L = len(self.layers)
        Kv, dh = self.layers[0].n_kv_heads, self.layers[0].d_head
        fX = config.floatX

        caches = []
        for _ in range(2 * L):
            caches.append(
                alloc(constant(np.asarray(0, dtype=fX)), batch, t_max, Kv, dh)
            )

        def step_fn(toks, pos, *cache_args):
            caches = list(cache_args)
            h = self.embed[toks]                       # (B, D)
            new_caches = []
            for i, layer in enumerate(self.layers):
                h, kc, vc = layer.step_batched(
                    h, caches[2 * i], caches[2 * i + 1], pos
                )
                new_caches += [kc, vc]
            logits = tm.dot(h, self.embed.T)           # (B, vocab)
            nxt = cast(tm.argmax(logits, axis=-1), "int64")
            return (nxt, pos + np.int64(1), *new_caches)

        outs, _ = scan(
            fn=step_fn,
            outputs_info=[cast(as_tensor_variable(first_tokens), "int64"),
                          constant(np.int64(0))] + caches,
            n_steps=n_steps,
        )
        return outs[0] if isinstance(outs, (list, tuple)) else outs

    def generate_batched_fn(self, batch: int, n_steps: int, t_max: int,
                            mode=None):
        from aesara_tpu_torch.compile.function import function
        from aesara_tpu_torch.tensor.type import lvector

        toks0 = lvector("toks0")
        toks = self.generate_batched_graph(toks0, batch, n_steps, t_max)
        return function([toks0], toks, mode=mode)
