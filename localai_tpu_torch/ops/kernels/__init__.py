"""Hand-written Hopper kernels of the port (CUDA C++, sm_90a).

  csrc/paged_decode.cu    K1, replaces ops/pallas/paged_attention.py::
                          paged_decode_attention_append
                          K3, replaces ops/pallas/paged_attention.py::
                          paged_decode_attention_append_quant (int8 pages)
  csrc/ragged_prefill.cu  K2, replaces ops/pallas/ragged_prefill.py::
                          ragged_prefill_attention_pallas
                          K2-int8, the same over int8 pages (the JAX package
                          ran int8 packs on its jnp op)
  csrc/contig_decode.cu   K4, replaces ops/pallas/decode_attention.py::
                          decode_attention_append_pallas
                          K5, replaces ops/pallas/decode_attention.py::
                          decode_attention_append_pallas_full
  csrc/decode_attention.cuh  the decode block K1, K3, K4 and K5 share
  csrc/quant_matmul.cu    W8 / W4, the weight-only int8 / int4 products
                          (no TPU kernel: XLA fused the JAX package's
                          ops/quant.py::mat into its einsums)

build.py compiles them at first use; the wrappers live in
ops/paged_attention.py (K1, K3), ops/ragged_prefill.py (K2, K2-int8),
ops/decode_attention.py (K4, K5) and ops/quant.py (W8, W4). ``LAUNCHES`` counts kernel launches per
wrapper: each wrapper adds one where it launches its kernel, and nowhere
else, so a run can show its main path went through the kernels. A
wrapper called while a CUDA graph is captured counts a launch that has
not run; the graph's owner (engine/decode_graph.py,
engine/prefill_graph.py) takes those counts back after the capture and
adds them once per replay, so the counts stay what the card ran.
"""

from __future__ import annotations

LAUNCHES = {"paged_decode_attention": 0,          # K1
            "ragged_prefill_attention": 0,        # K2
            "ragged_prefill_attention_int8": 0,   # K2-int8
            "paged_decode_attention_quant": 0,    # K3
            "decode_attention_append_contig": 0,  # K4
            "decode_attention_append_full": 0,    # K5
            "quant_matmul_int8": 0,               # W8
            "quant_matmul_int4": 0}               # W4


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0
