"""The paper's 2D associative processor: the Table-II cost model that meters
every integer softmax backend, the bit-serial LUT machinery (``isa``), the
functional simulator (``functional_sim``) and the Fig.-5 program on it
(``dataflow``, behind the ``ap_sim`` backend), and the paper's AP-vs-GPU
evaluation (``pipeline`` over ``gpu_model``'s analytic baselines)."""
