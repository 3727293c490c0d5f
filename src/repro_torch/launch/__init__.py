"""Launch drivers of the port (serving, training) and its launch tooling
(input shapes, the cost of a step under fake tensors, the H100 roofline,
dry runs)."""
