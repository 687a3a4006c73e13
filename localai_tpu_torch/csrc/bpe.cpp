// Byte-level BPE merge engine (C ABI, loaded via ctypes); the host-side
// encoder of localai_tpu_torch/engine/bpe_fast.py (localai_tpu/native/bpe.cpp).
//
// The reference's tokenizer hot path is llama.cpp's C++ (llama_tokenize);
// here the same role: Python owns pre-tokenization (exact GPT-2/llama-3
// regex) and the byte→unicode mapping, C++ owns the merge loop — the
// O(pieces × merges) part that dominates long-prompt encoding.
//
// Contract:
//   bpe_new(vocab_blob, vocab_len, merges_blob, merges_len) -> handle
//     vocab_blob:  '\n'-separated token strings; id = line index.
//     merges_blob: '\n'-separated "left right" pairs; rank = line index.
//   bpe_encode_piece(handle, piece, len, out_ids, max_out) -> n_ids (or -1)
//     piece: one pre-tokenized piece in byte-level unicode form (UTF-8).
//   bpe_free(handle)
//
// Build: localai_tpu_torch/native.py (g++ -O2 -shared -fPIC -std=c++17), at first use.

#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct PairHash {
    size_t operator()(const std::pair<uint32_t, uint32_t>& p) const {
        return (static_cast<size_t>(p.first) << 32) ^ p.second;
    }
};

struct BPE {
    std::unordered_map<std::string, int32_t> vocab;
    // merge rank keyed on (left symbol id, right symbol id) in vocab space:
    // every merge operand must itself be a vocab entry in well-formed BPE.
    std::unordered_map<std::pair<uint32_t, uint32_t>, int32_t, PairHash> ranks;
    std::vector<std::string> id_to_str;
};

std::vector<std::string> split_lines(const char* blob, long len) {
    std::vector<std::string> out;
    const char* end = blob + len;
    const char* start = blob;
    for (const char* p = blob; p <= end; ++p) {
        if (p == end || *p == '\n') {
            if (p > start) out.emplace_back(start, p - start);
            else out.emplace_back();
            start = p + 1;
        }
    }
    if (!out.empty() && out.back().empty()) out.pop_back();
    return out;
}

// Split a UTF-8 string into codepoint-granular symbol strings.
std::vector<std::string> utf8_symbols(const char* s, int len) {
    std::vector<std::string> out;
    int i = 0;
    while (i < len) {
        unsigned char c = static_cast<unsigned char>(s[i]);
        int n = 1;
        if ((c & 0x80) == 0x00) n = 1;
        else if ((c & 0xE0) == 0xC0) n = 2;
        else if ((c & 0xF0) == 0xE0) n = 3;
        else if ((c & 0xF8) == 0xF0) n = 4;
        if (i + n > len) n = 1;  // malformed tail: take the byte
        out.emplace_back(s + i, n);
        i += n;
    }
    return out;
}

}  // namespace

extern "C" {

void* bpe_new(const char* vocab_blob, long vocab_len,
              const char* merges_blob, long merges_len) {
    auto* bpe = new BPE();
    auto vlines = split_lines(vocab_blob, vocab_len);
    bpe->id_to_str = vlines;
    bpe->vocab.reserve(vlines.size() * 2);
    for (size_t i = 0; i < vlines.size(); ++i) {
        bpe->vocab.emplace(vlines[i], static_cast<int32_t>(i));
    }
    auto mlines = split_lines(merges_blob, merges_len);
    bpe->ranks.reserve(mlines.size() * 2);
    for (size_t r = 0; r < mlines.size(); ++r) {
        const std::string& line = mlines[r];
        size_t sp = line.find(' ');
        if (sp == std::string::npos) continue;
        auto li = bpe->vocab.find(line.substr(0, sp));
        auto ri = bpe->vocab.find(line.substr(sp + 1));
        if (li == bpe->vocab.end() || ri == bpe->vocab.end()) continue;
        std::pair<uint32_t, uint32_t> key(li->second, ri->second);
        if (bpe->ranks.find(key) == bpe->ranks.end()) {
            bpe->ranks.emplace(key, static_cast<int32_t>(r));
        }
    }
    return bpe;
}

void bpe_free(void* handle) { delete static_cast<BPE*>(handle); }

int bpe_encode_piece(void* handle, const char* piece, int len,
                     int32_t* out, int max_out) {
    BPE* bpe = static_cast<BPE*>(handle);
    // Symbols as vocab ids; unknown single codepoints are an error (-1):
    // byte-level alphabets always cover every byte char.
    auto syms_str = utf8_symbols(piece, len);
    std::vector<uint32_t> syms;
    syms.reserve(syms_str.size());
    for (auto& s : syms_str) {
        auto it = bpe->vocab.find(s);
        if (it == bpe->vocab.end()) return -1;
        syms.push_back(it->second);
    }

    // Greedy lowest-rank merge loop (quadratic worst case, tiny pieces in
    // practice — same shape as llama.cpp's llm_tokenizer_bpe).
    while (syms.size() >= 2) {
        int best_rank = INT32_MAX;
        size_t best_i = 0;
        for (size_t i = 0; i + 1 < syms.size(); ++i) {
            auto it = bpe->ranks.find({syms[i], syms[i + 1]});
            if (it != bpe->ranks.end() && it->second < best_rank) {
                best_rank = it->second;
                best_i = i;
            }
        }
        if (best_rank == INT32_MAX) break;
        const std::string merged =
            bpe->id_to_str[syms[best_i]] + bpe->id_to_str[syms[best_i + 1]];
        auto it = bpe->vocab.find(merged);
        if (it == bpe->vocab.end()) break;  // rank table out of sync — stop
        syms[best_i] = it->second;
        syms.erase(syms.begin() + best_i + 1);
    }

    if (static_cast<int>(syms.size()) > max_out) return -1;
    for (size_t i = 0; i < syms.size(); ++i) out[i] = static_cast<int32_t>(syms[i]);
    return static_cast<int>(syms.size());
}

}  // extern "C"
