"""NLP / embeddings: word2vec, SequenceVectors, ParagraphVectors, GloVe,
tokenization and the text pipeline under them; parse trees, the treebank
parser, the HMM tagger and its Viterbi decoder, the inverted index,
SentiWordNet and the bag-of-words vectorizers.

Port of ``deeplearning4j_tpu/nlp``. The host builds batches of (center,
context, negative) index arrays, or the fused path draws a whole epoch's
plan on the device; one step per batch gathers the embedding rows,
computes the skip-gram/CBOW/HS objective and adds the updates back with
fixed-order scatter-adds. The tagger decodes on the device
(``viterbi.py``); the trees, the CKY parser, the index, SentiWordNet and
the vectorizers are host code. ``DistributedWord2Vec`` and
``Word2Vec.fit_epochs(mesh=)`` train over a device mesh.
"""

from deeplearning4j_tpu_torch.nlp.tokenization import (  # noqa: F401
    DefaultTokenizerFactory,
    NGramTokenizerFactory,
)
from deeplearning4j_tpu_torch.nlp.sentence_iterator import (  # noqa: F401
    BasicLineIterator,
    CollectionSentenceIterator,
    FileSentenceIterator,
    LineSentenceIterator,
)
from deeplearning4j_tpu_torch.nlp.vocab import (  # noqa: F401
    Huffman,
    VocabCache,
    VocabWord,
)
from deeplearning4j_tpu_torch.nlp.word2vec import Word2Vec  # noqa: F401
from deeplearning4j_tpu_torch.nlp.epoch_kernels import (  # noqa: F401
    SkipGramCorpusCache,
)
from deeplearning4j_tpu_torch.nlp.sequencevectors import (  # noqa: F401
    SequenceVectors,
)
from deeplearning4j_tpu_torch.nlp.distributed import (  # noqa: F401
    DistributedWord2Vec,
)
from deeplearning4j_tpu_torch.nlp.word2vec_iterator import (  # noqa: F401
    Word2VecDataSetIterator,
)
from deeplearning4j_tpu_torch.nlp.glove import Glove  # noqa: F401
from deeplearning4j_tpu_torch.nlp.trees import (  # noqa: F401
    Tree,
    build_word_index,
)
from deeplearning4j_tpu_torch.nlp.treeparser import (  # noqa: F401
    TreebankParser,
)
from deeplearning4j_tpu_torch.nlp.postagger import HmmPosTagger  # noqa: F401
from deeplearning4j_tpu_torch.nlp.viterbi import Viterbi  # noqa: F401
from deeplearning4j_tpu_torch.nlp.invertedindex import (  # noqa: F401
    InvertedIndex,
)
from deeplearning4j_tpu_torch.nlp.sentiwordnet import SWN3  # noqa: F401
from deeplearning4j_tpu_torch.nlp.bagofwords import (  # noqa: F401
    BagOfWordsVectorizer,
    BaseTextVectorizer,
    TfidfVectorizer,
)
from deeplearning4j_tpu_torch.nlp.movingwindow import (  # noqa: F401
    Window,
    moving_window_matrix,
    window_indices,
    windows,
)
from deeplearning4j_tpu_torch.nlp.stopwords import (  # noqa: F401
    get_stop_words,
    is_stop_word,
    remove_stop_words,
)
from deeplearning4j_tpu_torch.nlp.paragraph_vectors import (  # noqa: F401
    ParagraphVectors,
)
