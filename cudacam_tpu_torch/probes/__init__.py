"""Probe tools of the port: each risky construct of the hysteresis kernels
alone (``hyster_kernel``, K13) and the 16-bit SIMD stencil question
(``i16_swar``, K14), as hand-written kernels with their plain versions.
``tools/port_kernel_probe.py`` and ``tools/port_i16_probe.py`` drive them."""
