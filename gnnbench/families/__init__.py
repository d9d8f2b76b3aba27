"""The port's side of each model family: its model, built at the
configuration's widths, and the message-passing op the family's layer
calls, set up for the roofline probe. The plain side is
``reference/<family>.py``."""
