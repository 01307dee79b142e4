"""Hand-written CUDA kernels of the serving path, with their plain
PyTorch versions.

* ``paged_attention`` — one-token decode attention over the paged KV
  pool (``csrc/paged_attention.cu``).
* ``moe_fused`` — the routed experts' SwiGLU FFN and weighted combine
  over the slot tables of one sort pass (``csrc/moe_fused.cu``).
* ``router_topk`` — masked softmax, top-k and renormalisation of router
  logits (``csrc/router_topk.cu``; its row function is also the
  megastep's route stage).
* ``decode_megastep`` — one attention+MoE block's whole decode step as
  one C call that enqueues a fixed chain of kernels
  (``csrc/decode_megastep.cu``).
* ``expert_ffn`` — the grouped expert SwiGLU over the dense-scatter
  MoE's capacity buffer (``csrc/expert_ffn.cu``).
* ``flash_prefill`` — causal GQA attention over a whole prompt, with
  positions and a sliding window (``csrc/flash_prefill.cu``).
* ``ssm_scan`` — the Mamba-1 selective scan over a whole prompt, and the
  one-token state update of decode (``csrc/ssm_scan.cu``).
* ``flash_prefill_bwd``, ``expert_ffn_bwd``, ``ssm_scan_bwd`` — the
  gradients of three of them, for training (``csrc/*_bwd.cu``).

``ops`` dispatches by the tensors' device: CUDA tensors launch the
kernel, CPU tensors run the plain version.  ``launches`` counts the
kernel launches, so a run can show that its path went through them.
"""
from collections import Counter

launches: Counter = Counter()
