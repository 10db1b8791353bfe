"""Identification strategy template.

Port of ``pgmpy_tpu/identification/base.py`` (reference:
``pgmpy/identification/base.py:1-88``).  A strategy
implements ``_identify(causal_graph) -> (role-annotated graph, success)``
and ``_validate(causal_graph) -> bool`` (does the graph's CURRENT role
assignment satisfy the strategy's criterion).  Graphs carry
exposure/outcome roles; identification returns a new graph with the
strategy's role (e.g. ``adjustment``, ``frontdoor``) filled in.
"""


class BaseIdentification:
    # subclasses narrow this to the graph classes they support
    supported_graph_types = ()

    def _validate_causal_graph(self, causal_graph):
        if self.supported_graph_types and not isinstance(
            causal_graph, self.supported_graph_types
        ):
            raise ValueError(
                f"The `causal_graph` must be an instance of "
                f"{self.supported_graph_types} for this method."
            )
        # raises when exposure/outcome roles are missing
        causal_graph.is_valid_causal_structure()

    def _identify(self, causal_graph):
        raise NotImplementedError

    def _validate(self, causal_graph):
        raise NotImplementedError

    def identify(self, causal_graph):
        """Run identification; returns ``(annotated_graph, success)`` where
        ``annotated_graph`` is a copy of ``causal_graph`` with this
        strategy's role assigned (a list of such graphs for
        ``variant='all'`` strategies)."""
        self._validate_causal_graph(causal_graph)
        return self._identify(causal_graph)

    def validate(self, causal_graph):
        """True when the graph's existing role assignment satisfies this
        strategy's criterion."""
        self._validate_causal_graph(causal_graph)
        return self._validate(causal_graph)

    def __call__(self, causal_graph):
        return self.identify(causal_graph)
