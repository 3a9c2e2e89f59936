"""The plain reference of the benchmark's cells: plain PyTorch in f32 with
TF32 off, which imports neither JAX nor anything of the program. It takes
the inputs and weights the benchmark made and works out everything else
again. ``Precision`` also gives the control: the same reference with the
operands of every matrix product and convolution rounded to fp8."""
