"""Whisper decoding: options, logit filters and the autoregressive loop.

Counterpart of mlx_audio_tpu/stt/models/whisper/decoding.py
(`DecodingOptions`, `DecodingResult`, `get_suppress_tokens`,
`DecodingTask`). The JAX package runs each window's sample loop, with every
logit filter and the timestamp state machine, as one `lax.while_loop`. Here
it is a Python loop of eager steps over the same fixed shapes: a KV buffer
of `n_text_ctx` columns under an additive mask, the prompt right-padded
into `PROMPT_BUCKETS`, `temperature` a device scalar. Every filter runs on
the device, and the timestamp state (last and penultimate token, the
largest timestamp) is device tensors: no value is read back per token.
Each step's finished flags are copied to the host without blocking, and
step i+1 is launched only once step i-1's flags are read, so the loop
stops at most `STEPS_AFTER_EOT` steps after the step that samples EOT
(the JAX loop stops at once). Tokens after EOT are forced to EOT, so the
kept tokens, their log-probabilities and `avg_logprob` are the same.

Random draws (temperature > 0, best-of) take a `torch.Generator` seeded
`int(temperature * 1000) + 7`, as the JAX package seeds its key, through a
Gumbel-max draw; the two packages' streams differ, so only greedy and beam
decoding equal the JAX package's tokens.
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ....ops.host_flags import FinishedFlags
from ....ops.kvcache import KVCache

PROMPT_BUCKETS = (4, 8, 16, 32, 64, 128, 256)
# steps the loop may launch after the one whose finished flags are all set:
# it reads the flags of step i-1 before launching step i+1
STEPS_AFTER_EOT = 1


def _bucket(n: int) -> int:
    for b in PROMPT_BUCKETS:
        if n <= b:
            return b
    return PROMPT_BUCKETS[-1]


@dataclass(frozen=True)
class DecodingOptions:
    task: str = "transcribe"
    language: Optional[str] = None
    temperature: float = 0.0
    sample_len: Optional[int] = None
    best_of: Optional[int] = None
    beam_size: Optional[int] = None
    patience: Optional[float] = None
    length_penalty: Optional[float] = None
    prompt: Optional[Union[str, List[int]]] = None
    prefix: Optional[Union[str, List[int]]] = None
    suppress_tokens: Optional[Union[str, Sequence[int]]] = "-1"
    suppress_blank: bool = True
    without_timestamps: bool = False
    max_initial_timestamp: Optional[float] = 1.0
    fp16: bool = False


@dataclass
class DecodingResult:
    tokens: List[int]
    text: str = ""
    language: str = "en"
    avg_logprob: float = np.nan
    no_speech_prob: float = np.nan
    temperature: float = 0.0
    compression_ratio: float = np.nan


def compression_ratio(text: str) -> float:
    b = text.encode("utf-8")
    return len(b) / len(zlib.compress(b)) if b else 0.0


def get_suppress_tokens(tokenizer, suppress_tokens="-1") -> Tuple[int, ...]:
    if isinstance(suppress_tokens, str):
        suppress_tokens = [int(t) for t in suppress_tokens.split(",")
                           if t] if suppress_tokens else []
    else:
        suppress_tokens = list(suppress_tokens or [])
    if -1 in suppress_tokens:
        suppress_tokens = [t for t in suppress_tokens if t >= 0]
        suppress_tokens.extend(tokenizer.non_speech_tokens)
    suppress_tokens.extend([
        tokenizer.transcribe, tokenizer.translate, tokenizer.sot,
        tokenizer.sot_prev, tokenizer.sot_lm,
    ])
    if tokenizer.no_speech is not None:
        suppress_tokens.append(tokenizer.no_speech)
    return tuple(sorted(set(suppress_tokens)))


def _gumbel_draw(logits: torch.Tensor, temperature: torch.Tensor,
                 generator: torch.Generator) -> torch.Tensor:
    """One categorical draw per row of logits (B, V) at `temperature`:
    argmax of logits / T plus Gumbel noise from `generator`."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    gumbel = -torch.log(-torch.log(u.clamp_(min=1e-20)))
    return torch.argmax(logits / temperature.clamp(min=1e-6) + gumbel, dim=-1)


class DecodingTask:
    """Greedy / best-of-N / beam decoding of one window.

    Greedy with a temperature is the transcribe default. `beam_size` runs a
    beam search whose candidates are the top-k of the flattened (G * V)
    scores, with the caches reindexed by source beam; `best_of` runs N
    temperature samples ranked by the length-penalty ranker."""

    def __init__(self, model, options: DecodingOptions):
        if options.beam_size is not None and options.best_of is not None:
            raise ValueError("beam_size and best_of can't be given together")
        if options.temperature == 0 and options.best_of is not None:
            raise ValueError("best_of with greedy sampling (T=0) is not "
                             "compatible")
        if options.patience is not None and options.beam_size is None:
            raise ValueError("patience requires beam_size to be given")
        if options.length_penalty is not None and not (
                0 <= options.length_penalty <= 1):
            raise ValueError("length_penalty (alpha) must be in [0, 1]")
        self.model = model
        self.options = options
        language = options.language or "en"
        self.tokenizer = model.get_tokenizer(language=language,
                                             task=options.task)
        self.sample_len = options.sample_len or model.dims.n_text_ctx // 2
        self.n_group = options.beam_size or options.best_of or 1
        self.suppress = get_suppress_tokens(self.tokenizer,
                                            options.suppress_tokens)
        self.sot_sequence = (
            self.tokenizer.sot_sequence_including_notimestamps
            if options.without_timestamps else self.tokenizer.sot_sequence)
        precision = 0.02
        self.max_initial_ts_index = (
            round(options.max_initial_timestamp / precision)
            if options.max_initial_timestamp else None)
        try:
            self.blank_token = self.tokenizer.encode(" ")[0]
        except Exception:
            self.blank_token = 220
        # how many steps the last run() launched (the kept tokens end at
        # EOT; up to STEPS_AFTER_EOT more steps may have run)
        self.last_steps = 0

    # ------------------------------------------------------------------

    def _make_filters(self, device):
        """The logit filters (decoding.py:134-201) as a function of the
        step's logits, its index (a host int: which step of the loop it
        is) and the device tensors of the timestamp state."""
        tok = self.tokenizer
        eot = tok.eot
        ts_begin = tok.timestamp_begin
        n_vocab = self.model.dims.n_vocab
        suppress_ids = torch.tensor(self.suppress + (tok.no_timestamps,),
                                    dtype=torch.long, device=device)
        blank_ids = torch.tensor([self.blank_token, eot], dtype=torch.long,
                                 device=device)
        use_ts = not self.options.without_timestamps
        max_init_idx = self.max_initial_ts_index
        vocab_idx = torch.arange(n_vocab, device=device)
        is_ts_col = vocab_idx >= ts_begin
        neg = float("-inf")

        def apply_filters(logits, n_sampled: int, last, penult, max_ts):
            logits = logits.to(torch.float32, copy=True)
            # SuppressBlank at the first sampled position
            if n_sampled == 0:
                logits[:, blank_ids] = neg
            # SuppressTokens
            logits[:, suppress_ids] = neg
            if not use_ts:
                logits[:, ts_begin:] = neg
                return logits
            # --- ApplyTimestampRules ---
            last_was_ts = last >= ts_begin
            if n_sampled >= 1:
                penult_was_ts = (penult >= ts_begin if n_sampled >= 2
                                 else torch.ones_like(last_was_ts))
                # last and penult were timestamps -> no timestamp now
                m1 = last_was_ts & penult_was_ts
                logits[:, ts_begin:].masked_fill_(m1[:, None], neg)
                # last a timestamp, penult text -> the pairing timestamp
                m2 = last_was_ts & ~penult_was_ts
                logits[:, :eot].masked_fill_(m2[:, None], neg)
            # timestamps must not decrease: mask ts < max_ts (or <= when
            # the last token was a timestamp)
            limit = torch.where(last_was_ts, max_ts + 1, max_ts)
            too_small = is_ts_col[None] & (vocab_idx[None] < limit[:, None])
            logits.masked_fill_((max_ts > 0)[:, None] & too_small, neg)
            if n_sampled == 0:
                # the first sampled token is a timestamp, bounded by
                # max_initial_timestamp
                logits[:, :eot + 1] = neg
                if max_init_idx is not None:
                    logits[:, ts_begin + max_init_idx + 1:] = neg
            # total timestamp probability above the best text token ->
            # force a timestamp
            logprobs = torch.log_softmax(logits, dim=-1)
            ts_logprob = torch.logsumexp(logprobs[:, ts_begin:], dim=-1)
            max_text = logprobs[:, :ts_begin].amax(dim=-1)
            force_ts = ts_logprob > max_text
            logits[:, :ts_begin].masked_fill_(force_ts[:, None], neg)
            return logits

        return apply_filters

    def _decode(self, mel, initial: List[int], temperature: float,
                mode: str):
        """Encode the window, prefill the prompt bucket, then sample up to
        sample_len tokens. `mode`: "sample" (one row per mel row, argmax at
        temperature 0, else a draw), "beam" or "best_of" (n_group rows over
        one mel). -> (tokens_buf (rows, n_ctx), steps run, sum_lp (rows,),
        no_speech_prob (rows,) or (1,) for a group), on the device."""
        from .whisper import cross_kv, decoder_forward, encoder_forward

        model = self.model
        dims = model.dims
        tok = self.tokenizer
        eot, ts_begin = tok.eot, tok.timestamp_begin
        dev = model.device
        n_ctx = dims.n_text_ctx
        plen = len(initial)
        pb = _bucket(plen)
        sot_index = initial.index(tok.sot)
        sample_len = min(self.sample_len, n_ctx - pb - 1)
        neg = float("-inf")

        feats = encoder_forward(model, mel)
        ckv = cross_kv(model, feats)
        if mode == "sample":
            b = feats.shape[0]
        else:
            b = self.n_group
            ckv = [(k.expand(b, -1, -1), v.expand(b, -1, -1))
                   for k, v in ckv]
        caches = KVCache.init(b, n_ctx, 1, dims.n_text_state, feats.dtype,
                              dev, n_layers=dims.n_text_layer)
        prompt = torch.zeros((b, pb), dtype=torch.long, device=dev)
        prompt[:, :plen] = torch.tensor(initial, dtype=torch.long, device=dev)
        cols = torch.arange(n_ctx, device=dev)
        positions = torch.arange(pb, device=dev).expand(b, pb)
        prefill_mask = torch.zeros((pb, n_ctx), device=dev).masked_fill_(
            cols[None, :] > torch.arange(pb, device=dev)[:, None], neg)
        logits_all, caches = decoder_forward(
            model, prompt, positions, ckv, caches, 0, prefill_mask[None, None])
        ns_rows = logits_all[:, sot_index] if mode == "sample" \
            else logits_all[:1, sot_index]
        no_speech_prob = torch.softmax(ns_rows.float(), dim=-1)[:, tok.no_speech]
        logits = logits_all[:, plen - 1]

        tokens_buf = torch.zeros((b, n_ctx), dtype=torch.long, device=dev)
        tokens_buf[:, :pb] = prompt
        finished = torch.zeros(b, dtype=torch.bool, device=dev)
        max_ts = torch.zeros(b, dtype=torch.long, device=dev)
        sum_lp = torch.zeros(b, device=dev)
        if mode == "beam":
            # only row 0 seeds candidates at step 0: every row holds the
            # same prompt
            sum_lp[1:] = neg
            frozen = torch.full((b, dims.n_vocab), neg, device=dev)
            frozen[:, eot] = 0.0
        temp = torch.tensor(float(temperature), device=dev)
        gen = torch.Generator(device=dev).manual_seed(
            int(temperature * 1000) + 7)
        apply_filters = self._make_filters(dev)
        flags = FinishedFlags(max(sample_len, 1), finished)
        lag = STEPS_AFTER_EOT + 1
        steps = 0
        for i in range(sample_len):
            if i >= lag and bool(flags.read(i - lag).all()):
                break
            cur = plen + i
            f_logits = apply_filters(logits, i, tokens_buf[:, cur - 1],
                                     tokens_buf[:, max(cur - 2, 0)], max_ts)
            logprobs = torch.log_softmax(f_logits, dim=-1)
            if mode == "beam":
                nv = logprobs.shape[-1]
                cand = torch.where(finished[:, None], frozen, logprobs) \
                    + sum_lp[:, None]
                top_scores, top_idx = torch.topk(cand.reshape(-1), b)
                src = top_idx // nv
                next_tok = top_idx % nv
                # reindex everything by source beam
                tokens_buf = tokens_buf[src]
                caches = KVCache(caches.k[:, src], caches.v[:, src])
                finished = finished[src]
                max_ts = max_ts[src]
                sum_lp = top_scores
            else:
                drawn = _gumbel_draw(f_logits, temp, gen)
                next_tok = (drawn if mode == "best_of" else torch.where(
                    temp <= 0.0, f_logits.argmax(dim=-1), drawn))
                tok_lp = logprobs.gather(1, next_tok[:, None])[:, 0]
                sum_lp = sum_lp + torch.where(finished, 0.0, tok_lp)
            next_tok = torch.where(finished, eot, next_tok)
            max_ts = torch.where((next_tok >= ts_begin) & ~finished,
                                 torch.maximum(max_ts, next_tok), max_ts)
            finished = finished | (next_tok == eot)
            tokens_buf[:, cur] = next_tok
            flags.record(i, finished)
            steps = i + 1
            if steps < sample_len:
                # the next logits: feed the sampled token at cur
                step_mask = torch.zeros(n_ctx, device=dev).masked_fill_(
                    cols > cur, neg)
                logits, caches = decoder_forward(
                    model, next_tok[:, None],
                    torch.full((b, 1), cur, dtype=torch.long, device=dev),
                    ckv, caches, cur, step_mask.view(1, 1, 1, n_ctx))
                logits = logits[:, 0]
        self.last_steps = steps
        return tokens_buf, steps, sum_lp, no_speech_prob

    def _rank(self, token_rows: List[np.ndarray],
              sum_lp: np.ndarray) -> int:
        """MaximumLikelihoodRanker."""
        alpha = self.options.length_penalty
        scores = []
        for toks, lp in zip(token_rows, sum_lp):
            n = len(toks) + 1
            penalty = n if alpha is None else ((5 + n) / 6) ** alpha
            scores.append(lp / penalty if penalty > 0 else -np.inf)
        return int(np.argmax(scores))

    @torch.inference_mode()
    def run(self, mel_segment, prompt: List[int],
            temperature: float = 0.0) -> DecodingResult:
        """Decode one (B=1) mel window with the given left-context prompt."""
        mel_segment = torch.as_tensor(mel_segment)
        if self.n_group > 1 and (self.options.beam_size or temperature > 0):
            return self._run_group(mel_segment, prompt, temperature)
        return self._run_greedy(mel_segment, prompt, temperature)

    def _initial_tokens(self, prompt: List[int]) -> List[int]:
        tok = self.tokenizer
        opts = self.options
        n_ctx = self.model.dims.n_text_ctx
        prompt = list(prompt)
        if prompt:
            prompt = [tok.sot_prev] + prompt[-(n_ctx // 2 - 1):]
        initial = prompt + list(self.sot_sequence)
        if opts.prefix:
            prefix = (tok.encode(" " + opts.prefix.strip())
                      if isinstance(opts.prefix, str) else list(opts.prefix))
            initial = initial + prefix
        return initial

    def _trim(self, row: np.ndarray) -> np.ndarray:
        eot_pos = np.where(row == self.tokenizer.eot)[0]
        return row[: eot_pos[0]] if len(eot_pos) else row

    def _result(self, tokens: np.ndarray, sum_lp: float, ns_prob: float,
                temperature: float) -> DecodingResult:
        tok = self.tokenizer
        text = tok.decode([t for t in tokens if t < tok.eot]).strip()
        return DecodingResult(
            tokens=[int(t) for t in tokens], text=text,
            language=self.options.language or "en",
            avg_logprob=sum_lp / (len(tokens) + 1),
            no_speech_prob=ns_prob,
            temperature=float(temperature),
            compression_ratio=compression_ratio(text))

    def _run_group(self, mel_segment, prompt: List[int],
                   temperature: float) -> DecodingResult:
        initial = self._initial_tokens(prompt)
        plen = len(initial)
        beam = self.options.beam_size is not None and temperature == 0.0
        tokens_buf, steps, sum_lp, ns_prob = self._decode(
            mel_segment, initial, temperature, "beam" if beam else "best_of")
        tokens_buf = tokens_buf[:, plen: plen + steps].cpu().numpy()
        sum_lp = sum_lp.cpu().numpy()
        rows = [self._trim(r) for r in tokens_buf]
        best = self._rank(rows, sum_lp)
        return self._result(rows[best], float(sum_lp[best]),
                            float(ns_prob.cpu()[0]), temperature)

    def _run_greedy(self, mel_segment, prompt: List[int],
                    temperature: float = 0.0) -> DecodingResult:
        initial = self._initial_tokens(prompt)
        plen = len(initial)
        tokens_buf, steps, sum_lp, ns_prob = self._decode(
            mel_segment, initial, temperature, "sample")
        tokens = self._trim(tokens_buf[0, plen: plen + steps].cpu().numpy())
        return self._result(tokens, float(sum_lp.cpu()[0]),
                            float(ns_prob.cpu()[0]), temperature)
