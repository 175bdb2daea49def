"""Models of the port: layers, attention, the dense transformer and its
facade (``models.model.Model``)."""
