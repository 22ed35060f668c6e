"""PyTorch/CUDA port of the MPC join: the join service's device path, with
p machines held as a leading tensor axis on one GPU and hand-written CUDA
kernels for the hash exchange and the local sorted join; and the LM
substrate's serve path (``configs``, ``models``, ``launch.serve``), whose
prefill runs the ``flash_attention`` and ``ssd_chunk`` kernels.

Entry points (:class:`repro_torch.mpc.JoinSession`,
:class:`repro_torch.mpc.DataplaneExecutor`, ``models.init_params``,
``launch.serve``) run on ``cuda`` unless the caller passes ``device="cpu"``,
which runs the kernels' plain PyTorch versions."""
