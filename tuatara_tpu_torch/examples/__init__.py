"""The port's example programs, counterparts of the repo's `examples/*.py`
with the same argv plus `--device` (default: the first CUDA card):

    python -m tuatara_tpu_torch.examples.resume [image] [weights_dir] [outputs_dir]
    python -m tuatara_tpu_torch.examples.table [image]
    python -m tuatara_tpu_torch.examples.serve page.png [...] [--weights DIR] [--batch 16]
"""
