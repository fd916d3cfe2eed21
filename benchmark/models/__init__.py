"""Model families: each module counts a family's operations from shapes
and holds its plain reference in PyTorch, which imports nothing of the
port. `common` holds what the families share: the TransE head, the margin
loss, Adam, the negatives' draw and the rank counts."""
