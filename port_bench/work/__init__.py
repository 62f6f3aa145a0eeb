"""
Each kernel's work, counted from the shapes of the mathematical operation
it performs (not from what an implementation iterates), and the least time
the card could take for it.

A module ``work/<kernel>.py`` gives ``KERNEL_NAMES`` (substrings of the
kernel's names in a device trace), ``COUNTER`` (the program's launch
counter, ``(module, key)``), and ``work(**shape) -> (flops, bytes)`` of one
operation; the cell's entry says which operations a step performs.
"""
