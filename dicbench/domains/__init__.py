"""Domain generators, one module a kind: a configuration's `domain.kind`
names the module (loaded by dicbench.spec.load), whose
`points(domain, frame)` returns (level-0 point lists, centers [S, 2] or
None for the point means)."""
