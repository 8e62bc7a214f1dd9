// Native FASTA/FASTQ reader + 2-bit encoder.
//
// The assembler's data-loader: the counterpart of the
// reference's C++ DataLayer (FastaReader.cpp parsing, Uncompress.cpp
// transparent gzip).  Parses FASTA/FASTQ (gzip included, via zlib),
// applies chastity filtering and quality trimming, and encodes bases
// straight into the fixed-shape uint8 code batches the device code
// consumes (A=0 C=1 G=2 T=3, BAD=4 padding) — so Python never touches
// per-base data on the hot path.
//
// Exposed as a plain C ABI for ctypes (no pybind11 in this image).

#include <zlib.h>

#include <cctype>
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Reader {
    gzFile f = nullptr;
    std::string path;
    int qtrim = 0;            // quality threshold (phred+33)
    bool chastity = true;
    int lookahead = -2;       // next char, -2 = unknown
    std::string err;

    // split state for reads longer than max_len
    std::string carry_seq;
    std::string carry_name;
    std::string carry_comment;
    size_t carry_off = 0;

    int peek() {
        if (lookahead == -2) lookahead = gzgetc(f);
        return lookahead;
    }
    int get() {
        int c = (lookahead == -2) ? gzgetc(f) : lookahead;
        lookahead = -2;
        return c;
    }
    bool getline(std::string& out) {
        out.clear();
        int c;
        while ((c = get()) != -1 && c != '\n') out.push_back(char(c));
        return !(c == -1 && out.empty());
    }
};

uint8_t code_of[256];
struct InitTables {
    InitTables() {
        memset(code_of, 4, sizeof code_of);
        code_of[uint8_t('A')] = code_of[uint8_t('a')] = 0;
        code_of[uint8_t('C')] = code_of[uint8_t('c')] = 1;
        code_of[uint8_t('G')] = code_of[uint8_t('g')] = 2;
        code_of[uint8_t('T')] = code_of[uint8_t('t')] = 3;
    }
} init_tables;

// CASAVA 1.8 "<read>:<Y|N>:..." or qseq trailing 0/1 (FastaReader::isChaste)
bool is_chaste(const std::string& comment) {
    if (comment.empty()) return true;
    size_t start = 0;
    while (start < comment.size()) {
        size_t end = comment.find(' ', start);
        if (end == std::string::npos) end = comment.size();
        const std::string fld = comment.substr(start, end - start);
        size_t c1 = fld.find(':');
        if (c1 != std::string::npos && c1 >= 1) {
            std::string first = fld.substr(0, c1);
            if ((first == "1" || first == "2" || first == "3") &&
                c1 + 1 < fld.size() &&
                (fld[c1 + 1] == 'Y' || fld[c1 + 1] == 'N') &&
                (c1 + 2 == fld.size() || fld[c1 + 2] == ':'))
                return fld[c1 + 1] == 'N';
        }
        start = end + 1;
    }
    const std::string& last =
        comment.substr(comment.find_last_of(' ') + 1);
    if (last == "0") return false;
    if (last == "1") return true;
    return true;
}

// trim bases with quality < q from both ends
void quality_trim(std::string& seq, const std::string& qual, int q) {
    if (q <= 0 || qual.size() != seq.size()) return;
    size_t lo = 0, hi = seq.size();
    while (lo < hi && qual[lo] - 33 < q) lo++;
    while (hi > lo && qual[hi - 1] - 33 < q) hi--;
    seq = seq.substr(lo, hi - lo);
}

// read one record; returns 0 eof, 1 ok, -1 error
int next_record(Reader* r, std::string& name,
                std::string& comment, std::string& seq) {
    for (;;) {
        int c = r->peek();
        if (c == -1) return 0;
        std::string header;
        if (c == '>') {
            r->get();
            if (!r->getline(header)) return 0;
            seq.clear();
            std::string line;
            while (r->peek() != '>' && r->peek() != -1) {
                if (!r->getline(line)) break;
                for (char ch : line)
                    if (!isspace((unsigned char)ch)) seq.push_back(ch);
            }
        } else if (c == '@') {
            r->get();
            if (!r->getline(header)) return 0;
            std::string qual, plus;
            if (!r->getline(seq)) return -1;
            if (!r->getline(plus) || plus.empty() || plus[0] != '+')
                return -1;
            if (!r->getline(qual)) return -1;
            quality_trim(seq, qual, r->qtrim);
        } else {
            r->err = "unrecognized record start";
            return -1;
        }
        size_t sp = header.find_first_of(" \t");
        comment = sp == std::string::npos ? "" : header.substr(sp + 1);
        name = sp == std::string::npos ? header : header.substr(0, sp);
        if (r->chastity && !is_chaste(comment)) continue;
        if (seq.empty()) continue;
        return 1;
    }
}

}  // namespace

extern "C" {

void* fastx_open(const char* path, int qtrim, int chastity) {
    Reader* r = new Reader();
    r->f = gzopen(path, "rb");
    if (!r->f) {
        delete r;
        return nullptr;
    }
    gzbuffer(r->f, 1 << 20);
    r->path = path;
    r->qtrim = qtrim;
    r->chastity = chastity != 0;
    return r;
}

// Fill a batch: codes[batch_size * max_len] (pre-filled by caller or
// overwritten here with BAD), lengths[batch_size], names packed as
// NUL-separated strings into names[names_cap].
// Returns number of reads produced (0 = EOF), or -1 on parse error.
long fastx_next_batch(void* handle, uint8_t* codes, int32_t* lengths,
                      char* names, long names_cap, int batch_size,
                      int max_len) {
    Reader* r = static_cast<Reader*>(handle);
    long n = 0;
    long name_pos = 0;
    std::string name, comment, seq;
    const int step = max_len / 2 > 0 ? max_len / 2 : 1;
    while (n < batch_size) {
        const std::string* use_seq;
        std::string piece, piece_name;
        if (!r->carry_seq.empty()) {
            // continue splitting a long read with max_len/2 overlap
            piece = r->carry_seq.substr(r->carry_off, max_len);
            piece_name =
                r->carry_name + ":" + std::to_string(r->carry_off);
            comment = r->carry_comment;
            r->carry_off += step;
            if (r->carry_off + size_t(max_len) / 2 >= r->carry_seq.size())
                r->carry_seq.clear();
            use_seq = &piece;
            name = piece_name;
        } else {
            int rc = next_record(r, name, comment, seq);
            if (rc <= 0) return n > 0 ? n : rc;
            if ((int)seq.size() > max_len) {
                r->carry_seq = seq;
                r->carry_name = name;
                r->carry_comment = comment;
                r->carry_off = step;
                piece = seq.substr(0, max_len);
                name += ":0";
                use_seq = &piece;
            } else {
                use_seq = &seq;
            }
        }
        const std::string& s = *use_seq;
        int L = (int)s.size();
        uint8_t* row = codes + (size_t)n * max_len;
        for (int i = 0; i < L; i++) row[i] = code_of[(uint8_t)s[i]];
        memset(row + L, 4, max_len - L);
        lengths[n] = L;
        // pack "name[\tcomment]\0" — the Python side splits on '\t'
        std::string packed = comment.empty() ? name : name + "\t" + comment;
        long need = (long)packed.size() + 1;
        if (name_pos + need > names_cap) return -2;  // caller buffer small
        memcpy(names + name_pos, packed.c_str(), need);
        name_pos += need;
        n++;
    }
    return n;
}

const char* fastx_error(void* handle) {
    return static_cast<Reader*>(handle)->err.c_str();
}

void fastx_close(void* handle) {
    Reader* r = static_cast<Reader*>(handle);
    if (r->f) gzclose(r->f);
    delete r;
}

}  // extern "C"
