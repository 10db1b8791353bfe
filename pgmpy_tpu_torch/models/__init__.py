from pgmpy_tpu_torch.models.discrete_bn import DiscreteBayesianNetwork
from pgmpy_tpu_torch.models.markov_network import DiscreteMarkovNetwork
from pgmpy_tpu_torch.models.factor_graph import FactorGraph
from pgmpy_tpu_torch.models.cluster_graph import ClusterGraph
from pgmpy_tpu_torch.models.junction_tree import JunctionTree
from pgmpy_tpu_torch.models.markov_chain import MarkovChain
from pgmpy_tpu_torch.models.naive_bayes import NaiveBayes
from pgmpy_tpu_torch.models.linear_gaussian_bn import LinearGaussianBayesianNetwork
from pgmpy_tpu_torch.models.dynamic_bn import DynamicBayesianNetwork, DynamicNode

# deprecated aliases kept for API familiarity with the reference
BayesianNetwork = DiscreteBayesianNetwork
MarkovNetwork = DiscreteMarkovNetwork

__all__ = [
    "DiscreteBayesianNetwork",
    "DiscreteMarkovNetwork",
    "FactorGraph",
    "ClusterGraph",
    "JunctionTree",
    "MarkovChain",
    "NaiveBayes",
    "LinearGaussianBayesianNetwork",
    "DynamicBayesianNetwork",
    "DynamicNode",
    "BayesianNetwork",
    "MarkovNetwork",
]
