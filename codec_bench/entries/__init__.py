"""One module per container kind: how the benchmark calls the codec under
test, the reference's job for a compress check, the control, and the
stream words a container holds (for the roofline shares)."""
