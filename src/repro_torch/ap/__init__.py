"""The paper's 2D associative processor, as far as the port needs it: the
Table-II cost model that meters every integer softmax backend."""
