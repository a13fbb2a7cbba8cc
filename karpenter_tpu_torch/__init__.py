"""karpenter_tpu_torch: the karpenter-tpu scheduling solver in PyTorch,
with hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

The JAX package (karpenter_tpu) is the reference this package is tested
against; nothing here imports it or JAX. Entry point:
karpenter_tpu_torch.controllers.provisioning.TorchScheduler.
"""
