"""Training for the port (counterpart of `tuatara_tpu/train/`): the losses
(`losses.py`), the joint step, its state and the optax-equal optimizer
(`trainer.py`), checkpoints that either package's engine serves
(`checkpoint.py`) and the fit loops (`run.py`). Plain PyTorch autograd: the
JAX package's training runs no Pallas kernel either."""
