"""PyTorch/CUDA port of the MPC join: the join service's device path, with
p machines held as a leading tensor axis on one GPU and hand-written CUDA
kernels for the hash exchange and the local sorted join.

Entry points (:class:`repro_torch.mpc.JoinSession`,
:class:`repro_torch.mpc.DataplaneExecutor`) run on ``cuda`` unless the
caller passes ``device="cpu"``, which runs the kernels' plain PyTorch
versions."""
