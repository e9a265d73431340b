"""GBNF parsing (gbnf.py), the pushdown automaton and its token-mask
builder (automaton.py, the plain reference), the native runtime the
engine uses (native.py over csrc/grammar.cc) and the JSON-schema
converter (json_schema.py)."""
