"""The plain reference that decides a run's ``correct``.

Plain PyTorch and NumPy, written from the model's equations and the
configuration file's numbers: it imports nothing of the port, of JAX or
of the JAX package, and takes nothing that the port has made.  The
benchmark hands it the same inputs and seeded weights that it hands the
port; it computes in float32 with TF32 off (float64 where it scores a
hypothesis on the host).  ``quant.fp8`` puts it at the control's
precision: the precision below the configuration's bf16.
"""
