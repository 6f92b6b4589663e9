// Native FASTA reader.
//
// C++ port of recgraph_tpu/io/fasta.py (itself a port of the
// reference's src/sequences.rs:5-46): reads a multi-record FASTA,
// uppercases, maps '-' -> 'N', prepends the '$' sentinel to every
// read, and returns one flat buffer:
//
//   name '\t' $SEQ '\n'  per record
//
// which the Python side splits (cheap: one decode + splitlines).

#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>

extern "C" {

// Returns a malloc'd buffer (caller frees via free_buffer) and writes
// its length to *out_len; null on IO error.
char* read_fasta(const char* path, int64_t* out_len) {
    FILE* f = fopen(path, "rb");
    if (!f) return nullptr;
    std::string out;
    out.reserve(1 << 20);
    std::string line;
    char buf[1 << 16];
    bool in_seq = false;
    auto flush_line = [&](const std::string& ln) {
        if (ln.empty()) return;
        if (ln[0] == '>') {
            if (in_seq) out += '\n';
            size_t end = ln.find_first_of(" \t", 1);
            out.append(ln, 1, (end == std::string::npos ? ln.size() : end) - 1);
            out += '\t';
            out += '$';
            in_seq = true;
        } else if (in_seq) {
            for (char c : ln) {
                if (c == '\r') continue;
                c = (char)toupper((unsigned char)c);
                out += (c == '-') ? 'N' : c;
            }
        }
    };
    while (fgets(buf, sizeof buf, f)) {
        size_t len = strlen(buf);
        bool complete = len > 0 && buf[len - 1] == '\n';
        line.append(buf, complete ? len - 1 : len);
        if (complete) {
            flush_line(line);
            line.clear();
        }
    }
    flush_line(line);
    fclose(f);
    if (in_seq) out += '\n';
    char* res = (char*)malloc(out.size() + 1);
    memcpy(res, out.data(), out.size());
    res[out.size()] = 0;
    *out_len = (int64_t)out.size();
    return res;
}

void free_buffer(char* p) { free(p); }

}  // extern "C"
