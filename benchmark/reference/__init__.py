"""Plain PyTorch reference of the benchmark's training paths.

Float32 throughout (TF32 off, set by the caller), no kernel and nothing of
the port: the foveated retina's documented semantics (``retina``), the
foveated ResNet and its projector (``resnet``), NT-Xent and the SimCLR
step (``simclr``), the DETR classifier and its step (``detr``), the
optimizers and schedules (``optim``), and the precision of the products
(``precision``: exact, or the lower-precision control).
"""
