"""Motion generators, one module a kind: a mix's `motion.kind` names the
module (loaded by dicbench.spec.load), whose `frames(frame, mix, seed,
device)` returns the sequence's frames [pairs + 1, H, W, C] uint8 on
`device`, made from the seed."""
