"""The plain reference of the benchmark: plain PyTorch and numpy, importing
nothing of the program under test. It works out C's pattern, the block
products, the block norms and the kept set again from the A and B blocks
that the benchmark made, and judges the program's output blocks against
them (``judge.block_err``)."""
