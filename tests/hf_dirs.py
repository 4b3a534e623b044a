"""Tiny Hugging Face checkpoint directories for the port's tests, written
with transformers' own save_pretrained, and a word-level tokenizer
(transformers and tokenizers are imported inside the helpers: a test file
gates on them with pytest.importorskip). chip_smoke.py's phase 15 saves the
same tokenizer into its Gemma-2-2B directory on the card."""
import torch

# a tiny Gemma-2: head_dim 24 != 64 / 4, both softcaps, a window of 8 on
# alternate layers, tie_word_embeddings at its default (left out of
# config.json by save_pretrained)
GEMMA2 = ("Gemma2Config", dict(
    vocab_size=96, hidden_size=64, intermediate_size=128, num_hidden_layers=3,
    num_attention_heads=4, num_key_value_heads=2, head_dim=24, max_position_embeddings=128,
    rms_norm_eps=1e-5, query_pre_attn_scalar=32.0, attn_logit_softcapping=50.0,
    final_logit_softcapping=30.0, sliding_window=8))


def save_hf(path, cls_name, keys, form="single", dtype=torch.float32, seed=0):
    """A seeded transformers model of config class `cls_name` saved under
    `path` as a single model.safetensors ("single"), a sharded index
    ("sharded") or pytorch_model.bin ("bin"), in `dtype`; returns the
    model (eval, f32)."""
    import transformers

    cfg = getattr(transformers, cls_name)(**keys, attn_implementation="eager")
    torch.manual_seed(seed)
    model = transformers.AutoModelForCausalLM.from_config(cfg).eval()
    shard = {"max_shard_size": "20KB"} if form == "sharded" else {}
    model.to(dtype).save_pretrained(path, safe_serialization=form != "bin", **shard)
    return model.float()


def save_word_tokenizer(path, vocab_size):
    """A word-level tokenizer over `vocab_size` ids (Gemma's specials at 0,
    1, 2, 3; then the chat roles and words "w7", ...), <bos> prepended when
    special tokens are added, a chat template; saved into `path`. Returns
    it."""
    from tokenizers import Tokenizer, models, pre_tokenizers, processors
    from transformers import PreTrainedTokenizerFast

    words = ["<pad>", "<eos>", "<bos>", "<unk>", "user", "assistant", "system"]
    words += [f"w{i}" for i in range(len(words), vocab_size)]
    vocab = {w: i for i, w in enumerate(words)}
    tok = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.WhitespaceSplit()
    tok.post_processor = processors.TemplateProcessing(
        single="<bos> $A", special_tokens=[("<bos>", vocab["<bos>"])])
    fast = PreTrainedTokenizerFast(tokenizer_object=tok, bos_token="<bos>", eos_token="<eos>",
                                   unk_token="<unk>", pad_token="<pad>")
    fast.chat_template = ("{% for m in messages %}{{ m['role'] }} {{ m['content'] }} "
                          "{% endfor %}{% if add_generation_prompt %}assistant{% endif %}")
    fast.save_pretrained(path)
    return fast
