"""Plain fp32 PyTorch reference of what the benchmark's cells compute.

Written from the HiFi-GAN paper and its public code (jik876/hifi-gan,
``models.py``, ``meldataset.py``, ``train.py``), in upstream key names. It
imports nothing of the program under test and none of the program's plain
kernel versions or test helpers; it recomputes from the inputs everything
the program derives in set-up (folded or packed weights). Every conv goes
through a :class:`~port_bench.reference.numerics.Numerics`, which is exact
fp32 for the reference and a lower precision for the control.
"""
