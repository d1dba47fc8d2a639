"""BERT, after ``paddle_tpu/models/bert.py`` (acceptance config 2, BERT-base
MLM): embeddings (word + position + token type, LayerNorm, dropout), a
``nn.TransformerEncoder`` stack (post-LN, GELU), the tanh pooler and the
masked-LM head, whose decoder is tied to the word embedding.

Parameter names and layouts are the reference's
(``bert.embeddings.word_embeddings.weight``,
``bert.encoder.layers.0.self_attn.q_proj.weight`` ``[in, out]``,
``cls.decoder_bias``, ...), so ``convert.bert_from_numpy`` loads the JAX
model's ``param_arrays`` with no renaming or transposes.

The tied decoder weight has no state-dict entry of its own: the head keeps
a reference to the embedding *module* (unregistered, so it adds no
parameter) and reads its ``weight`` at call time. ``jit.functional_call``
and ``jit.to_static`` swap the embedding's weight, and the head then sees
the swapped one, as the reference's taped matmul does.

Unmasked attention runs the flash kernels (#2; #5/#6 under autograd) at
the encoder's head dim; an ``attention_mask`` (``[B, S]`` of 1 keep / 0
pad) becomes the reference's additive ``(1 - m) * -1e4`` bias and runs the
masked softmax in plain PyTorch.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from .. import nn as pnn
from ..nn import functional as F

__all__ = ["BertConfig", "BertEmbeddings", "BertPooler", "BertModel",
           "BertLMPredictionHead", "BertForMaskedLM",
           "BertPretrainingCriterion"]


@dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    pad_token_id: int = 0


class BertEmbeddings(nn.Module):
    def __init__(self, config: BertConfig, device=None, dtype=torch.float32,
                 generator=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        h = config.hidden_size
        self.word_embeddings = pnn.Embedding(config.vocab_size, h, **kw)
        self.position_embeddings = pnn.Embedding(
            config.max_position_embeddings, h, **kw)
        self.token_type_embeddings = pnn.Embedding(config.type_vocab_size,
                                                   h, **kw)
        self.layer_norm = pnn.LayerNorm(h, epsilon=config.layer_norm_eps,
                                        **kw)
        self.dropout = pnn.Dropout(config.hidden_dropout_prob,
                                   generator=generator)

    def forward(self, input_ids, token_type_ids=None, position_ids=None):
        b, s = input_ids.shape
        if position_ids is None:
            position_ids = torch.arange(
                s, device=input_ids.device).unsqueeze(0).expand(b, s)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        x = (self.word_embeddings(input_ids)
             + self.position_embeddings(position_ids)
             + self.token_type_embeddings(token_type_ids))
        return self.dropout(self.layer_norm(x))


class BertPooler(nn.Module):
    def __init__(self, config: BertConfig, device=None, dtype=torch.float32):
        super().__init__()
        self.dense = pnn.Linear(config.hidden_size, config.hidden_size,
                                device=device, dtype=dtype)

    def forward(self, hidden):
        return F.tanh(self.dense(hidden[:, 0]))


class BertModel(nn.Module):
    """``nn.TransformerEncoder`` stack + pooler; returns ``(sequence
    output [B, S, H], pooled [B, H])``."""

    def __init__(self, config: BertConfig, device=None, dtype=torch.float32,
                 generator=None):
        super().__init__()
        self.config = config
        self.embeddings = BertEmbeddings(config, device, dtype, generator)
        layer = pnn.TransformerEncoderLayer(
            d_model=config.hidden_size,
            nhead=config.num_attention_heads,
            dim_feedforward=config.intermediate_size,
            dropout=config.hidden_dropout_prob,
            activation=config.hidden_act,
            attn_dropout=config.attention_probs_dropout_prob,
            act_dropout=0.0, normalize_before=False, device=device,
            dtype=dtype, generator=generator)
        self.encoder = pnn.TransformerEncoder(layer,
                                              config.num_hidden_layers)
        self.pooler = BertPooler(config, device, dtype)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                position_ids=None):
        if attention_mask is not None:
            m = torch.as_tensor(attention_mask, device=input_ids.device)
            attention_mask = (1.0 - m[:, None, None, :].float()) * -1e4
        x = self.embeddings(input_ids, token_type_ids, position_ids)
        seq = self.encoder(x, src_mask=attention_mask)
        return seq, self.pooler(seq)


class BertLMPredictionHead(nn.Module):
    """transform (Linear) → activation → LayerNorm → ``x @ E^T + bias``
    with ``E`` the word embedding of ``embedding`` (an ``nn.Embedding``),
    read at call time."""

    def __init__(self, config: BertConfig, embedding, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.transform = pnn.Linear(config.hidden_size, config.hidden_size,
                                    device=device, dtype=dtype)
        self.layer_norm = pnn.LayerNorm(config.hidden_size,
                                        epsilon=config.layer_norm_eps,
                                        device=device, dtype=dtype)
        self.activation = config.hidden_act
        # not registered: the embedding owns the tied weight's only entry
        object.__setattr__(self, "_embedding", embedding)
        self.decoder_bias = nn.Parameter(torch.zeros(
            (config.vocab_size,), device=device, dtype=dtype))

    def forward(self, hidden):
        x = self.layer_norm(getattr(F, self.activation)(
            self.transform(hidden)))
        weight = self._embedding.weight
        return torch.matmul(x, weight.to(x.dtype).t()) + self.decoder_bias


class BertForMaskedLM(nn.Module):
    def __init__(self, config: BertConfig, device=None, dtype=torch.float32,
                 generator=None):
        super().__init__()
        self.bert = BertModel(config, device, dtype, generator)
        self.cls = BertLMPredictionHead(
            config, self.bert.embeddings.word_embeddings, device, dtype)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        seq, _ = self.bert(input_ids, token_type_ids, attention_mask)
        return self.cls(seq)


class BertPretrainingCriterion(nn.Module):
    """The MLM loss: mean cross entropy (f32 log-sum-exp) over the
    positions whose label is not negative (ignore index -100); 0 when none
    is."""

    def __init__(self, vocab_size: int):
        super().__init__()
        self.vocab_size = vocab_size

    def forward(self, prediction_scores, masked_lm_labels):
        labels = torch.as_tensor(masked_lm_labels,
                                 device=prediction_scores.device)
        logits = prediction_scores.float()
        valid = labels >= 0
        safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, safe.unsqueeze(-1)).squeeze(-1)
        per_tok = torch.where(valid, logz - gold, torch.zeros_like(logz))
        return per_tok.sum() / valid.sum().clamp_min(1)
