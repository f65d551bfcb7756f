"""The plain reference that decides ``correct``: NumPy only.

It imports neither ``jax`` nor the JAX package ``repro`` nor anything of
``repro_torch``, and takes nothing the program made but the outputs it
judges (answers, latencies, job times) and, for the DES, the structure of
its compactions and the SSTs each GET probed (see ``des``).
"""
