"""Tool calling and grammar-constrained decoding (counterpart of
localai_tpu/functions/): ``grammars`` compiles GBNF and JSON schemas into
the automaton whose per-state penalty rows mask the sampler's bias, and
``parse`` reads tool calls out of generated text."""
