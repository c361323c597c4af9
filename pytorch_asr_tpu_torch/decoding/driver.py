"""Decoding driver: the port's counterpart of ``pytorch_asr_tpu.decoding.driver``.

Batch loop over the eval set with the configured decoder (``greedy``,
``prefix_beam``, ``attention_beam`` or ``joint_beam``), corpus WER/CER and
decode RTF, on a decode-side bucket ladder; optional dump of
``<prefix>.ref.tsv`` / ``<prefix>.hyp.tsv``, scoreable with ``python -m
pytorch_asr_tpu_torch.eval_wer``.  Over several ranks (``torchrun``) every
rank reads the same batches and decodes its rows of the ('data', 'model')
mesh; with ``decode.shard_beams`` and a model axis above 1 the beams shard
over the model ranks (``decoding/prefix_beam_sharded.py``); the metrics are
a count-sum.
"""

from __future__ import annotations

import time

import torch

from pytorch_asr_tpu_torch.configs.base import ExperimentConfig
from pytorch_asr_tpu_torch.data import (
    BucketedDataset,
    build_eval_dataset,
    corpus_audio_lengths,
    corpus_transcripts,
    get_tokenizer,
)
from pytorch_asr_tpu_torch.data.bucket_opt import optimize_buckets, padding_efficiency
from pytorch_asr_tpu_torch.decoding.attention_beam import attention_beam_search
from pytorch_asr_tpu_torch.decoding.eval_metrics import local_hyps_refs, reduce_decode_metrics
from pytorch_asr_tpu_torch.decoding.lm import read_arpa, tensorize
from pytorch_asr_tpu_torch.decoding.lm_hashed import HashedNgramLM, build_hashed_lm
from pytorch_asr_tpu_torch.decoding.prefix_beam import prefix_beam_search
from pytorch_asr_tpu_torch.decoding.prefix_beam_sharded import prefix_beam_search_sharded
from pytorch_asr_tpu_torch.evaluate import eval_step, model_outputs
from pytorch_asr_tpu_torch.models.asr_model import ASRModel
from pytorch_asr_tpu_torch.models.lm_rnn import CharRNNLM
from pytorch_asr_tpu_torch.parallel.distributed import topology
from pytorch_asr_tpu_torch.parallel.mesh import Mesh, make_mesh, shard_batch_global, use_mesh
from pytorch_asr_tpu_torch.training.lm import load_rnn_lm

DENSE_LM_FLOATS = 64_000_000   # lm_backend "auto": dense while V**order fits


def load_lm(cfg: ExperimentConfig, device: str | torch.device,
            tokenizer=None) -> torch.Tensor | HashedNgramLM | CharRNNLM | None:
    """The fusion LM named by ``cfg.decode.lm_path`` on ``device``, or None
    without a path: an ``.npz`` is a char RNN LM saved by either package's
    ``train_lm``; an ARPA file (over chars, or over a BPE vocab's pieces) is
    read and, per ``cfg.decode.lm_backend``, tensorized to a dense
    (V^(n-1), V) float32 table (``dense``, or ``auto`` while V^order <=
    DENSE_LM_FLOATS) or compiled to the hashed tables of
    ``decoding/lm_hashed.py`` (``hashed``, and ``auto`` past that), as the
    JAX driver does."""
    path = cfg.decode.lm_path
    if not path:
        return None
    tok = tokenizer or get_tokenizer(cfg.data.vocab)
    if path.endswith(".npz"):
        return load_rnn_lm(path, tok, device)
    lm = read_arpa(path, tok)
    backend = cfg.decode.lm_backend
    if backend == "dense" or (backend == "auto"
                              and tok.vocab_size ** lm.order <= DENSE_LM_FLOATS):
        return torch.from_numpy(tensorize(lm, tok)).to(device)
    return build_hashed_lm(lm, tok.vocab_size, device)


def make_decode_fn(cfg: ExperimentConfig, model: ASRModel, lm=None, mesh: Mesh | None = None):
    """(host batch) -> (ids (B, L), lengths (B,)) on the model's device.
    ``lm`` is what ``load_lm`` returns: a dense table, the hashed tables,
    the RNN LM, or None.
    With ``decode.shard_beams`` and a ``mesh`` whose model axis is above 1
    the search shards its beams over the model ranks; it then runs over all
    chars and ignores ``ext_top_a`` and ``lm_top_k``, as the JAX driver
    passes neither to its sharded search.  ``attention_beam`` and
    ``joint_beam`` (the attention search with the CTC prefix scorer at
    weight ``decode.joint_ctc_weight``) need a model with a decoder."""
    method = cfg.decode.method
    if method == "greedy":
        return lambda batch: eval_step(model, batch)
    dec = cfg.decode
    rnn_lm = lm if isinstance(lm, CharRNNLM) else None
    hash_lm = lm if isinstance(lm, HashedNgramLM) else None
    lm_table = lm if rnn_lm is None and hash_lm is None else None
    has_lm = lm is not None
    tok = get_tokenizer(cfg.data.vocab)
    if method == "prefix_beam":
        kw = dict(beam_size=dec.beam_size, lm_table=lm_table,
                  lm_alpha=dec.lm_alpha if has_lm else 0.0,
                  lm_beta=dec.lm_beta if has_lm else 0.0, max_len=dec.max_decode_len,
                  rnn_lm=rnn_lm, sos_id=tok.sos_id, hash_lm=hash_lm)
        if dec.shard_beams and mesh is not None and mesh.model > 1:
            def decode_fn(batch):
                out = model_outputs(model, batch)
                toks, lens, _ = prefix_beam_search_sharded(out["ctc_logits"], out["enc_len"],
                                                           mesh, **kw)
                return toks, lens

            return decode_fn

        def decode_fn(batch):
            out = model_outputs(model, batch)
            toks, lens, _ = prefix_beam_search(out["ctc_logits"], out["enc_len"],
                                               ext_top_a=dec.ext_top_a, lm_top_k=dec.lm_top_k,
                                               **kw)
            return toks, lens

        return decode_fn
    if method in ("attention_beam", "joint_beam"):
        ctc_weight = dec.joint_ctc_weight if method == "joint_beam" else 0.0

        def decode_fn(batch):
            out = model_outputs(model, batch)
            toks, lens, _ = attention_beam_search(
                model, out["enc"], out["enc_len"], tok.sos_id, tok.eos_id,
                beam_size=dec.beam_size, max_len=dec.max_decode_len,
                length_norm=dec.length_norm,
                ctc_logits=out["ctc_logits"] if ctc_weight > 0 else None,
                ctc_weight=ctc_weight, lm_table=lm_table,
                lm_alpha=dec.lm_alpha if has_lm else 0.0, rnn_lm=rnn_lm, hash_lm=hash_lm,
                coverage_beta=dec.coverage_beta, coverage_tau=dec.coverage_tau)
            return toks, lens

        return decode_fn
    raise ValueError(f"unknown decode method {method!r}")


def decode_ladder(cfg: ExperimentConfig, dataset: BucketedDataset):
    """Decode-side bucket ladder: with ``cfg.decode.auto_buckets`` > 0 the
    corpus is re-bucketed with that many DP-optimal buckets for decoding
    only.  Returns (dataset, padding efficiency or None)."""
    n = cfg.decode.auto_buckets
    if n <= 0:
        return dataset, None
    corpus, tok = dataset._corpus, dataset.tokenizer
    audio_lens = corpus_audio_lengths(corpus)
    label_lens = [len(tok.encode(t)) for t in corpus_transcripts(corpus)]
    audio_b, label_b = optimize_buckets(audio_lens, label_lens, n)
    ds = BucketedDataset(corpus, batch_size=dataset.batch_size, bucket_audio_lens=audio_b,
                         bucket_label_lens=label_b, tokenizer=tok)
    return ds, padding_efficiency(audio_lens, audio_b)


def decode_dataset(cfg: ExperimentConfig, model: ASRModel,
                   dataset: BucketedDataset | None = None, max_batches: int | None = None,
                   dump_path: str | None = None, step: int | None = None,
                   mesh: Mesh | None = None) -> dict:
    """Decode ``dataset`` (by default the eval split of ``cfg.data``:
    ``data.eval_data_config``)
    with ``cfg.decode.method`` on the decode ladder; returns method, wer,
    cer, num_utts, decode_rtf, ``step`` when given, and
    padding_efficiency_decode when the ladder is on.  ``dump_path`` writes
    ``<prefix>.ref.tsv`` and ``<prefix>.hyp.tsv`` (``id<TAB>text`` lines);
    over several ranks each model-index-0 rank writes its own rows to
    ``<prefix>.p<rank>.{ref,hyp}.tsv``.  ``mesh``: the ranks' mesh (by
    default one made from ``cfg.mesh``)."""
    device = model.ctc_head.weight.device
    dataset = dataset or build_eval_dataset(cfg.data, cfg.frontend.sample_rate)
    eval_ds, pad_eff = decode_ladder(cfg, dataset)
    mesh = mesh or make_mesh(cfg.mesh, batch_size=eval_ds.batch_size)
    decode_fn = make_decode_fn(cfg, model, load_lm(cfg, device, dataset.tokenizer), mesh)
    refs: list[str] = []
    hyps: list[str] = []
    audio_sec = 0.0
    t0 = time.perf_counter()
    with torch.inference_mode(), use_mesh(mesh):
        for i, batch in enumerate(eval_ds.epoch_batches(seed=0)):
            if max_batches is not None and i >= max_batches:
                break
            rows = shard_batch_global(mesh, batch)
            if not mesh.has_rows:
                continue
            ids, lens = decode_fn(rows)
            if mesh.counts_rows:
                r, h, a_sec = local_hyps_refs(eval_ds.tokenizer, rows, ids.cpu().numpy(),
                                              lens.cpu().numpy(), cfg.frontend.sample_rate)
                refs.extend(r)
                hyps.extend(h)
                audio_sec += a_sec
    dt = time.perf_counter() - t0
    topo = topology()
    if dump_path and topo["world_size"] > 1:
        dump_path = f"{dump_path}.p{topo['rank']}" if mesh.counts_rows else None
    if dump_path:
        for suffix, lines in ((".ref.tsv", refs), (".hyp.tsv", hyps)):
            with open(dump_path + suffix, "w") as fh:
                for i, text in enumerate(lines):
                    fh.write(f"utt{i:06d}\t{text}\n")
    result = {"method": cfg.decode.method, **reduce_decode_metrics(refs, hyps, audio_sec, dt)}
    if step is not None:
        result["step"] = step
    if pad_eff is not None:
        result["padding_efficiency_decode"] = pad_eff
    return result
