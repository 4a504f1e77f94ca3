"""Paper-reproduction PLM configs (port of `repro.configs.bert`):
BERT/RoBERTa-family encoders (post-LN, learned positions, segment
embeddings, pooler + classifier), the backbones of the paper's GLUE-style
experiments (Tables 2-5)."""
from repro_torch.common.types import Group, ModelCfg, Slot
from repro_torch.configs.util import smoke_dims


def _encoder(name, layers, d, heads, d_ff, vocab, n_types=2) -> ModelCfg:
    return ModelCfg(
        name=name,
        family="encoder",
        d_model=d,
        n_heads=heads,
        n_kv_heads=heads,
        head_dim=d // heads,
        d_ff=d_ff,
        vocab_size=vocab,
        groups=(Group((Slot("attn"),), layers),),
        norm="layernorm",
        norm_eps=1e-12,
        ln_placement="post",
        act="gelu",
        gated_mlp=False,
        attn_bias=True,
        mlp_bias=True,
        pos="learned",
        n_segment_types=n_types,
        pooler=True,
        n_classes=2,
        max_seq_len=512,
        param_dtype="float32",
        compute_dtype="float32",
        q_chunk=128,
        kv_chunk=128,
        sequence_sharding=False,
        shard_profile="tp",
    )


def bert_base() -> ModelCfg:
    return _encoder("bert-base", 12, 768, 12, 3072, 30522)


def bert_large() -> ModelCfg:
    return _encoder("bert-large", 24, 1024, 16, 4096, 30522)


def roberta_base() -> ModelCfg:
    return _encoder("roberta-base", 12, 768, 12, 3072, 50265, n_types=1)


def roberta_large() -> ModelCfg:
    return _encoder("roberta-large", 24, 1024, 16, 4096, 50265, n_types=1)


def bert_small() -> ModelCfg:
    """4L/256d encoder: the CPU-trainable stand-in for benchmark sweeps."""
    return _encoder("bert-small", 4, 256, 4, 1024, 8192)


def bert_tiny() -> ModelCfg:
    return _encoder("bert-tiny", 2, 128, 2, 512, 2048)


def config() -> ModelCfg:
    return bert_base()


def smoke() -> ModelCfg:
    return smoke_dims(bert_base(), groups=(Group((Slot("attn"),), 2),),
                      n_kv_heads=4)
