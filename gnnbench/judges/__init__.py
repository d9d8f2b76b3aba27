"""The check of each path, in plain PyTorch: it reads what the program
produced in its first steps (``paths/<path>.py``'s record) only to judge
it, and follows those steps with the plain reference computed from the
generated inputs. It imports nothing of the port.

``readings(record, data, cell, prec, details)`` returns the compared
numbers of the program (and fills ``details``, where given, with each
step's and each leaf's gaps); ``control(record, data, cell, kinds)`` the
same numbers with the reference put in the program's place in the
control's precision (TF32), in plain f32 or with the half-batch fault.
"""
