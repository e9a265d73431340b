"""The port's pure-Python tokenizers with merges (engine/bpe.py,
engine/tokenizer.py::BPETokenizer, engine/gguf_tokenizer.py,
engine/detok.py) against the references, on the CPU:

  * tokenizer.json files that ``tokenizers``' BpeTrainer writes here on a
    seeded corpus, in the byte-level Llama-3 form (its split regex, then
    ByteLevel; the BOS post-processor), the SentencePiece form
    (Prepend / Replace normalizer, byte_fallback, the Replace /
    ByteFallback / Fuse / Strip decoder) and the Metaspace form: encode
    and decode (specials skipped and kept) equal
    ``AutoTokenizer.from_pretrained(dir)``'s over seeded texts with CJK,
    Devanagari, emoji, combining marks, ``²½Ⅻ``, digit runs,
    contractions, whitespace runs and specials inside the text;
  * the grammar's ``token_strings`` equals the JAX function's over the HF
    tokenizer, specials as None;
  * streamed text (the incremental detokenizer) equals the JAX
    detokenizer's over the HF tokenizer, token by token;
  * ``GGUFTokenizer`` equals JAX's on the tests/test_gguf.py metadata and
    on a gpt2 vocabulary with merges drawn here;
  * the merge engine equals the naive loop over all pairs;
  * tokenizer.json parts outside the two families raise
    NotImplementedError naming the part, when the file is loaded.
"""

from __future__ import annotations

import tests.torch_cpu  # noqa: F401  (one torch CPU thread)

import json
import os

import numpy as np
import pytest

from localai_tpu.engine import detok as jdetok
from localai_tpu.engine import gguf_tokenizer as jgguf
from localai_tpu.functions.grammars import automaton as jauto
from localai_tpu_torch.engine import bpe as tbpe
from localai_tpu_torch.engine import detok as tdetok
from localai_tpu_torch.engine import gguf_tokenizer as tgguf
from localai_tpu_torch.engine import tokenizer as ttok
from localai_tpu_torch.functions.grammars import automaton as tauto
from tests.test_gguf import _spm_meta

LLAMA3_SPLIT = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+"
                r"|\p{N}{1,3}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)"
                r"|\s+")
LLAMA3_SPECIALS = ["<|begin_of_text|>", "<|end_of_text|>",
                   "<|start_header_id|>", "<|end_header_id|>", "<|eot_id|>"]

# what the seeded texts are drawn from: ASCII words and punctuation, digit
# runs, contractions, whitespace runs, CJK, Devanagari (with its
# combining signs), emoji (with a skin-tone modifier), a combining acute,
# and the three characters Python's [^\W\d_] takes for letters
POOL = (list("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ") * 6
        + list("0123456789") * 3 + list("    \n\t.,;:!?'\"-()") * 3
        + list("日本語中文字") + list("नमस्तेहिन्दी") + ["😀", "🚀", "👍🏽"]
        + ["\u00e9", "\u00e4", "e\u0301"] + list("²½Ⅻ")
        + ["'s", "'t", "'re", "'ll", "n't", "'S", "'VE"]
        + ["   ", "\n\n", " \t ", "\r\n", "1234567"])
WORDS = ["the", "cat", "sat", "on", "mat", "hello", "world", "don't", "it's",
         "we're", "123", "4567", "日本", "नमस्ते", "😀", "café", "naïve"]


def texts(seed: int, n: int, hi: int = 30) -> list:
    rng = np.random.default_rng(seed)
    return ["".join(POOL[int(i)] for i in rng.integers(0, len(POOL),
                                                       size=int(rng.integers(1, hi))))
            for _ in range(n)]


def corpus(seed: int, n: int = 400) -> list:
    rng = np.random.default_rng(seed)
    return [" ".join(WORDS[int(i)] for i in rng.integers(
        0, len(WORDS), size=int(rng.integers(3, 12)))) for _ in range(n)] \
        + texts(seed + 1, n)


SPECIAL_TEXTS = ["<|start_header_id|>user<|end_header_id|>\n\nhi<|eot_id|>",
                 "<|begin_of_text|><|begin_of_text|>x", "a<|eot_id|>b",
                 "<s>hello</s> x", "", " ", "  lead", "a  b   c\n\n\nd",
                 "¡Hola! ¿Qué tal?", "x <unk> y"]


def write_byte_level(d: str, seed: int = 0, vocab: int = 600) -> None:
    """The Llama-3 form: Split(regex) + ByteLevel, ignore_merges, the BOS
    post-processor, clean_up_tokenization_spaces as Llama-3 sets it."""
    from tokenizers import (Regex, Tokenizer, decoders, models, pre_tokenizers,
                            processors, trainers)

    tok = Tokenizer(models.BPE(ignore_merges=True))
    tok.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.Split(Regex(LLAMA3_SPLIT), behavior="isolated",
                             invert=False),
        pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False)])
    tok.decoder = decoders.ByteLevel()
    tr = trainers.BpeTrainer(vocab_size=vocab, show_progress=False,
                             initial_alphabet=pre_tokenizers.ByteLevel.alphabet(),
                             special_tokens=LLAMA3_SPECIALS)
    tok.train_from_iterator(corpus(seed), trainer=tr)
    bos = tok.token_to_id("<|begin_of_text|>")
    tok.post_processor = processors.Sequence([
        processors.ByteLevel(trim_offsets=False),
        processors.TemplateProcessing(
            single="<|begin_of_text|> $A",
            pair="<|begin_of_text|> $A <|begin_of_text|> $B",
            special_tokens=[("<|begin_of_text|>", bos)])])
    os.makedirs(d, exist_ok=True)
    tok.save(os.path.join(d, "tokenizer.json"))
    with open(os.path.join(d, "tokenizer_config.json"), "w") as f:
        json.dump({"tokenizer_class": "PreTrainedTokenizerFast",
                   "bos_token": "<|begin_of_text|>", "eos_token": "<|eot_id|>",
                   "clean_up_tokenization_spaces": True,
                   "chat_template": "{{ '<|start_header_id|>' }}"}, f)


def write_sentencepiece(d: str, seed: int = 0, vocab: int = 600,
                        metaspace: bool = False) -> None:
    """The Llama-2 / Mistral form: <unk> <s> </s>, the 256 <0xNN> pieces,
    then the trained merges' tokens; byte_fallback and fuse_unk; the
    Prepend / Replace normalizer (or a Metaspace pre-tokenizer); the
    Replace / ByteFallback / Fuse / Strip decoder; <s> added by the
    post-processor. The trainer's alphabet is cut to 60 characters, so
    rare characters take the byte fallback."""
    from tokenizers import (Tokenizer, decoders, models, normalizers,
                            pre_tokenizers, trainers)

    tok = Tokenizer(models.BPE(byte_fallback=True, unk_token="<unk>",
                               fuse_unk=True))
    if metaspace:
        tok.pre_tokenizer = pre_tokenizers.Metaspace(
            replacement="▁", prepend_scheme="first", split=False)
    else:
        tok.normalizer = normalizers.Sequence([normalizers.Prepend("▁"),
                                               normalizers.Replace(" ", "▁")])
    tok.decoder = decoders.Sequence([decoders.Replace("▁", " "),
                                     decoders.ByteFallback(), decoders.Fuse(),
                                     decoders.Strip(" ", 1, 0)])
    tr = trainers.BpeTrainer(vocab_size=vocab, limit_alphabet=60,
                             special_tokens=["<unk>", "<s>", "</s>"],
                             show_progress=False)
    tok.train_from_iterator(corpus(seed), trainer=tr)
    spec = json.loads(tok.to_str())
    order = (["<unk>", "<s>", "</s>"] + [f"<0x{b:02X}>" for b in range(256)]
             + [t for t, _ in sorted(spec["model"]["vocab"].items(),
                                     key=lambda kv: kv[1])
                if t not in ("<unk>", "<s>", "</s>")])
    spec["model"]["vocab"] = {t: i for i, t in enumerate(order)}
    spec["added_tokens"] = [dict(a, id=spec["model"]["vocab"][a["content"]])
                            for a in spec["added_tokens"]]
    bos = {"SpecialToken": {"id": "<s>", "type_id": 0}}
    spec["post_processor"] = {
        "type": "TemplateProcessing",
        "single": [bos, {"Sequence": {"id": "A", "type_id": 0}}],
        "pair": [bos, {"Sequence": {"id": "A", "type_id": 0}}, bos,
                 {"Sequence": {"id": "B", "type_id": 1}}],
        "special_tokens": {"<s>": {"id": "<s>", "ids": [1], "tokens": ["<s>"]}}}
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "tokenizer.json"), "w") as f:
        json.dump(spec, f, ensure_ascii=False)
    with open(os.path.join(d, "tokenizer_config.json"), "w") as f:
        json.dump({"tokenizer_class": "PreTrainedTokenizerFast",
                   "bos_token": "<s>", "eos_token": "</s>",
                   "unk_token": "<unk>"}, f)


FORMS = {"byte_level": write_byte_level, "sentencepiece": write_sentencepiece,
         "metaspace": lambda d: write_sentencepiece(d, metaspace=True)}


@pytest.fixture(scope="module")
def vocabs(tmp_path_factory):
    """form -> (HF AutoTokenizer, the port's tokenizer) of one written dir."""
    from transformers import AutoTokenizer

    out = {}
    for form, write in FORMS.items():
        d = str(tmp_path_factory.mktemp(f"tok_{form}"))
        write(d)
        out[form] = (AutoTokenizer.from_pretrained(d), ttok.load_tokenizer(d))
    return out


@pytest.mark.parametrize("form", list(FORMS))
def test_encode_equals_hf(vocabs, form):
    hf, port = vocabs[form]
    assert isinstance(port, ttok.BPETokenizer)
    for text in texts(7, 300) + SPECIAL_TEXTS:
        assert port.encode(text) == hf.encode(text), repr(text)
        assert (port.encode(text, add_special_tokens=False)
                == hf.encode(text, add_special_tokens=False)), repr(text)


@pytest.mark.parametrize("form", list(FORMS))
def test_decode_equals_hf(vocabs, form):
    """Decode of HF's ids, specials skipped and kept, equals HF's; with
    the specials skipped it gives the text back where HF does."""
    hf, port = vocabs[form]
    rng = np.random.default_rng(11)
    for text in texts(8, 300) + SPECIAL_TEXTS:
        ids = hf.encode(text)
        for skip in (False, True):
            assert (port.decode(ids, skip_special_tokens=skip)
                    == hf.decode(ids, skip_special_tokens=skip)), repr(text)
    # arbitrary id runs (split multi-byte pieces, lone byte pieces)
    n = port.get_vocab_size()
    for _ in range(200):
        ids = rng.integers(0, n, size=int(rng.integers(1, 12))).tolist()
        for skip in (False, True):
            assert (port.decode(ids, skip_special_tokens=skip)
                    == hf.decode(ids, skip_special_tokens=skip)), ids


@pytest.mark.parametrize("form", list(FORMS))
def test_specials_and_vocab_surface_equal_hf(vocabs, form):
    hf, port = vocabs[form]
    assert port.eos_token_id == hf.eos_token_id
    assert port.all_special_ids == hf.all_special_ids
    assert port.get_vocab() == hf.get_vocab()
    # a rendered llama3 header is its one id each
    if form == "byte_level":
        ids = port.encode("<|start_header_id|>user<|end_header_id|>",
                          add_special_tokens=False)
        assert ids[0] == hf.convert_tokens_to_ids("<|start_header_id|>")
        assert ids[-1] == hf.convert_tokens_to_ids("<|end_header_id|>")


@pytest.mark.parametrize("form", list(FORMS))
def test_token_strings_match_jax(vocabs, form):
    hf, port = vocabs[form]
    assert tauto.token_strings(port) == jauto.token_strings(hf)


@pytest.mark.parametrize("form", list(FORMS))
def test_streamed_text_equals_the_jax_detokenizer(vocabs, form):
    """Token by token, the port's incremental detokenizer over the port's
    tokenizer gives the JAX detokenizer's deltas over HF's (multi-byte
    merged pieces split across tokens, SentencePiece's leading ▁)."""
    hf, port = vocabs[form]
    for text in texts(9, 120) + SPECIAL_TEXTS:
        ids = hf.encode(text)
        j, t = jdetok.IncrementalDetokenizer(hf), tdetok.IncrementalDetokenizer(port)
        assert [t.push(i) for i in ids] == [j.push(i) for i in ids], repr(text)
        assert t.flush() == j.flush() and t.text == j.text


def _naive_merge(ranks: dict, parts: list) -> list:
    """The JAX GGUF tokenizer's loop: the lowest (rank, position) pair."""
    parts = list(parts)
    while len(parts) > 1:
        r, i = min((ranks.get((parts[i], parts[i + 1]), 1 << 30), i)
                   for i in range(len(parts) - 1))
        if r == 1 << 30:
            break
        parts = parts[:i] + [parts[i] + parts[i + 1]] + parts[i + 2:]
    return parts


def _random_merges(rng, alphabet: str, n: int) -> list:
    toks, merges = list(alphabet), []
    for _ in range(n):
        a, b = toks[int(rng.integers(len(toks)))], toks[int(rng.integers(len(toks)))]
        if len(a + b) <= 6 and a + b not in toks:
            toks.append(a + b)
            merges.append((a, b))
    return merges


def test_merge_engine_equals_the_naive_loop():
    rng = np.random.default_rng(5)
    merges = _random_merges(rng, "abcd", 300)
    bpe = tbpe.BPE(merges)
    for _ in range(500):
        word = "".join(rng.choice(list("abcd"), size=int(rng.integers(1, 60))))
        assert bpe.merge(list(word)) == _naive_merge(bpe.ranks, list(word))
        assert bpe.word(word) == bpe.word(word) == _naive_merge(bpe.ranks, list(word))


def _gpt2_meta(seed: int = 3):
    rng = np.random.default_rng(seed)
    base = [jgguf._BYTE_TO_CHAR[b] for b in range(256)]
    merges = _random_merges(rng, "".join(jgguf._BYTE_TO_CHAR[b]
                                         for b in b"helo wrd.t'sa"), 200)
    vocab = base + [a + b for a, b in merges]
    return {"tokenizer.ggml.model": "gpt2", "tokenizer.ggml.tokens": vocab,
            "tokenizer.ggml.merges": [f"{a} {b}" for a, b in merges],
            "tokenizer.ggml.eos_token_id": None}


@pytest.mark.parametrize("meta", [_spm_meta, _gpt2_meta], ids=["spm", "gpt2"])
def test_gguf_tokenizer_equals_jax(meta):
    j, t = jgguf.GGUFTokenizer(meta()), tgguf.GGUFTokenizer(meta())
    for text in (texts(12, 200) + ["hello world", "héllo→", "hello world hello",
                                   "the hello's world. tale"]):
        for special in (True, False):
            ids = j.encode(text, add_special_tokens=special)
            assert t.encode(text, add_special_tokens=special) == ids, repr(text)
            assert t.decode(ids) == j.decode(ids)
            assert t.decode(ids, False) == j.decode(ids, False)
            assert t.convert_ids_to_tokens(ids) == j.convert_ids_to_tokens(ids)
        jd, td = jdetok.IncrementalDetokenizer(j), tdetok.IncrementalDetokenizer(t)
        ids = j.encode(text, add_special_tokens=False)
        assert [td.push(i) for i in ids] == [jd.push(i) for i in ids]
    assert t.get_vocab_size() == j.get_vocab_size()
    # from_gguf reads the file, as JAX's does: a missing one raises its error
    for f in (jgguf.from_gguf, tgguf.from_gguf):
        with pytest.raises(FileNotFoundError):
            f("/nonexistent.gguf")


@pytest.mark.parametrize("part,edit", [
    ("pre_tokenizer", {"pre_tokenizer": {"type": "Whitespace"}}),
    ("normalizer", {"normalizer": {"type": "Lowercase"}}),
    ("decoder", {"decoder": {"type": "WordPiece", "prefix": "##",
                             "cleanup": True}}),
    ("post_processor", {"post_processor": {"type": "BertProcessing",
                                           "sep": ["</s>", 2],
                                           "cls": ["<s>", 1]}}),
    ("model", {"model": {"type": "WordPiece", "vocab": {"a": 0},
                         "merges": ["a a"]}}),
    ("continuing_subword_prefix", {"model.continuing_subword_prefix": "##"}),
    ("lstrip", {"added_tokens.lstrip": True}),
    ("regex \\\\w", {"pre_tokenizer": {"type": "Split",
                                       "pattern": {"Regex": r"\w+"},
                                       "behavior": "Isolated",
                                       "invert": False}}),
])
def test_outside_the_families_raises_naming_the_part(tmp_path, part, edit):
    write_sentencepiece(str(tmp_path))
    path = tmp_path / "tokenizer.json"
    spec = json.loads(path.read_text())
    for key, value in edit.items():
        if key == "model.continuing_subword_prefix":
            spec["model"]["continuing_subword_prefix"] = value
        elif key == "added_tokens.lstrip":
            spec["added_tokens"][0]["lstrip"] = value
        else:
            spec[key] = value
    path.write_text(json.dumps(spec))
    with pytest.raises(NotImplementedError, match=part.split(" ")[0]):
        ttok.load_tokenizer(str(tmp_path))


def test_no_merges_keeps_the_byte_level_reader(tmp_path):
    from tests.tinymodel import write_tiny_tokenizer

    write_tiny_tokenizer(str(tmp_path))
    assert isinstance(ttok.load_tokenizer(str(tmp_path)), ttok.ByteLevelTokenizer)


@pytest.mark.parametrize("decoder", [False, True], ids=["legacy", "decoder"])
def test_special_tokens_map_read_as_transformers_reads_it(tmp_path, decoder):
    """special_tokens_map.json overrides tokenizer_config.json's special
    tokens unless the config carries added_tokens_decoder."""
    from transformers import AutoTokenizer

    d = str(tmp_path)
    write_byte_level(d)
    path = os.path.join(d, "tokenizer_config.json")
    with open(path) as f:
        conf = json.load(f)
    if decoder:
        conf["added_tokens_decoder"] = {"4": {
            "content": "<|eot_id|>", "lstrip": False, "normalized": False,
            "rstrip": False, "single_word": False, "special": True}}
    with open(path, "w") as f:
        json.dump(conf, f)
    with open(os.path.join(d, "special_tokens_map.json"), "w") as f:
        json.dump({"eos_token": "<|end_of_text|>",
                   "additional_special_tokens": ["<|start_header_id|>"]}, f)
    hf, port = AutoTokenizer.from_pretrained(d), ttok.load_tokenizer(d)
    assert port.eos_token_id == hf.eos_token_id
    assert port.all_special_ids == hf.all_special_ids
