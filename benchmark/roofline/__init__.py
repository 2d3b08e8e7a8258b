"""The yardstick's arithmetic: peaks of the card, the work a kernel's
call needs (operations and bytes from its shapes), and the model FLOPs
behind ``mfu``.  Frozen here so that a change to the program cannot
change what it is measured against."""
