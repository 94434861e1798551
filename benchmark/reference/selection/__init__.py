"""Frozen plain copy of the port's selection model, loss and text encoder,
the training cell's reference.

Each file is the port's module of the commit that defined the benchmark
(``models/{layers,attention,selection,text}.py``, ``train/loss.py``) with
its imports pointed inside this package, the tensor-parallel hooks reduced
to one process (``tp.py``), and the flash-attention kernels replaced by
``attention_plain.py``: the kernels' plain arithmetic with the same dropout
hash, differentiated by autograd.
"""
